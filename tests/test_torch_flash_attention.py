"""The port's flash attention on the CPU — the plain versions of the three
CUDA kernels behind the ``torch.autograd.Function`` — against the JAX
package's Pallas kernels in interpret mode and ``jax.grad``, for every case
of ``tests/test_flash_attention.py`` at its tolerances (2e-5 forward in f32,
5e-4 gradients, 2e-2 bf16). A CPU call launches no CUDA kernel, so the
launch counters stay at 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from easydl_tpu.ops import flash_attention as jfa  # noqa: E402
from easydl_tpu_torch.ops import flash_attention as tfa  # noqa: E402


def qkv(seed, b=2, s_q=128, s_k=None, h=4, d=32):
    rng = np.random.default_rng(seed)
    s_k = s_k or s_q
    return (rng.standard_normal((b, s_q, h, d), dtype=np.float32),
            rng.standard_normal((b, s_k, h, d), dtype=np.float32),
            rng.standard_normal((b, s_k, h, d), dtype=np.float32))


def jax_flash(q, k, v, causal, block_q, block_k, dtype=jnp.float32):
    return jfa.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal,
                               block_q=block_q, block_k=block_k, interpret=True)


def jax_grads(q, k, v, causal, block_q, block_k):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, interpret=True)
        return (o * jnp.cos(o)).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def torch_grads(q, k, v, causal):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*t, causal=causal)
    (o * torch.cos(o)).sum().backward()
    return [x.grad.numpy() for x in t]


@pytest.fixture(autouse=True)
def no_launches():
    tfa.reset_launches()
    yield
    assert tfa.launches == tfa.expected_launches()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [32, 64, 128])
def test_forward_matches_jax_kernel(causal, block):
    q, k, v = qkv(0)
    want = np.asarray(jax_flash(q, k, v, causal, block, block))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_k", [(64, 64), (64, 32)])
def test_lse_matches_jax_kernel(causal, s_q, s_k):
    """(O, lse) of the plain forward against the Pallas ``_fwd`` on the
    [bh, s, d] view, dead rows' +|f32.min| lse included."""
    q, k, v = (x[0].transpose(1, 0, 2).copy() for x in qkv(5, s_q=s_q, s_k=s_k))
    scale = q.shape[-1] ** -0.5
    o_j, lse_j = jfa._fwd(*map(jnp.asarray, (q, k, v)), causal=causal, scale=scale,
                          block_q=32, block_k=32, interpret=True)
    o_t, lse_t = tfa.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal, scale)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_kernel(causal):
    q, k, v = qkv(1, b=1, s_q=64, h=2, d=16)
    want = jax_grads(q, k, v, causal, 32, 32)
    for g, w, name in zip(torch_grads(q, k, v, causal), want, "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4, err_msg=f"d{name}")


def test_uneven_blocks_and_rectangular():
    q, k, v = qkv(2, s_q=96, d=64)
    want = np.asarray(jax_flash(q, k, v, True, 96, 96))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_causal_cross_length_bottom_right_aligned():
    q, k, v = qkv(4, s_q=32, s_k=64, h=2)
    want = np.asarray(jax_flash(q, k, v, True, 16, 16))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    want_g = jax_grads(q, k, v, True, 16, 16)
    for g, w, name in zip(torch_grads(q, k, v, True), want_g, "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4, err_msg=f"d{name}")


def test_causal_cross_length_sq_gt_sk_dead_rows():
    q, k, v = qkv(6, s_q=64, s_k=32, h=2, d=16)
    n_dead = 64 - 32
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    np.testing.assert_array_equal(got[:, :n_dead], 0.0)
    for bq in (16, 32):
        want = np.asarray(jax_flash(q, k, v, True, bq, 16))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"bq={bq}")
    grads = torch_grads(q, k, v, True)
    np.testing.assert_array_equal(grads[0][:, :n_dead], 0.0)
    for g, w, name in zip(grads, jax_grads(q, k, v, True, 32, 16), "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4, err_msg=f"d{name}")


def test_untileable_length_needs_no_fallback():
    """72 has no block divisor for the Pallas kernel (JAX falls back to its
    reference); the port's kernels mask ragged tails, so it runs as is."""
    q, k, v = qkv(5, s_q=72, d=16)
    want = np.asarray(jax_flash(q, k, v, True, 48, 48))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_bf16_inputs():
    q, k, v = qkv(3, s_q=64)
    want = np.asarray(jax_flash(q, k, v, True, 32, 32, dtype=jnp.bfloat16), np.float32)
    got = tfa.flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_kernel_wrappers_reject_mixed_devices():
    q = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_fwd(q, q.to("meta"), q, True, 1.0)


# ---------------------------------------------------------------------------
# the card's tolerance against the tensor-core kernels' rounding
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _masked_scores(q, k, causal, scale):
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        s_q, s_k = s.shape[-2:]
        keep = torch.ones(s_q, s_k, dtype=torch.bool).tril(s_k - s_q)
        s = s.masked_fill(~keep, tfa.NEG_INF)
    return s


def emulated_fwd(q, k, v, causal, scale):
    """The bf16 tensor-core forward: f32 scores and softmax, P rounded to
    bf16 before P·V, the row sum taken from the unrounded P."""
    s = _masked_scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    dead = m <= tfa.NEG_INF * 0.5
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.where(dead, 0.0, torch.matmul(_bf16(p), v.float()) / l)
    lse = torch.where(dead, -tfa.NEG_INF, m + torch.log(l))
    return o.to(q.dtype), lse.squeeze(-1)


def _p_and_ds(q, k, v, do, lse, delta, causal, scale):
    p = torch.exp(_masked_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def emulated_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """The bf16 tensor-core dq: dS rounded to bf16 before its product with k;
    the scale applied to dq in f32."""
    _, ds = _p_and_ds(q, k, v, do, lse, delta, causal, scale)
    return (torch.matmul(_bf16(ds), k.float()) * scale).to(q.dtype)


def emulated_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """The bf16 tensor-core dk/dv: Pᵀ and dSᵀ rounded to bf16 before their
    products with dO and with the unscaled q; the scale applied to dk in f32."""
    p, ds = _p_and_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.matmul(_bf16(p).transpose(1, 2), do.float())
    dk = torch.matmul(_bf16(ds).transpose(1, 2), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _assert_within(got, want, tol, what):
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    assert bool((err <= bound).all()), (
        f"{what}: max |err| {err.max().item():.3g}, worst err/bound "
        f"{(err / bound).max().item():.3g} over {atol} + {rtol}*|x|")


@pytest.mark.parametrize("s", [256, 200])
def test_bf16_rounding_of_p_and_ds_is_inside_the_card_tolerance(s):
    """The bf16 kernels round P (forward), dS (dq), Pᵀ and dSᵀ (dk/dv) to bf16
    before the second product, as the TPU kernel's default-precision dot does. An
    emulation of that rounding stays inside ``chip_smoke.TOL[bfloat16]`` of
    the plain versions, which compute those products in f32, at a bf16 causal
    shape with a ragged length; and inside the JAX bf16 tolerance (2e-2) of
    the Pallas kernels in interpret mode."""
    tol = _chip_smoke().TOL[torch.bfloat16]
    rng = np.random.default_rng(11)
    bh, d = 8, 64
    q, k, v, do = (rng.standard_normal((bh, s, d), dtype=np.float32) for _ in range(4))
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    scale = d ** -0.5

    o_plain, lse_plain = tfa.flash_fwd_plain(tq, tk, tv, True, scale)
    o_emu, lse_emu = emulated_fwd(tq, tk, tv, True, scale)
    _assert_within(o_emu, o_plain, tol["fwd"], "O")
    torch.testing.assert_close(lse_emu, lse_plain, rtol=0, atol=0)

    dq_plain, delta = tfa.flash_bwd_dq_plain(tq, tk, tv, o_plain, tdo, lse_plain, True, scale)
    args = (tq, tk, tv, tdo, lse_plain, delta, True, scale)
    dk_plain, dv_plain = tfa.flash_bwd_dkv_plain(*args)
    dq_emu = emulated_bwd_dq(*args)
    dk_emu, dv_emu = emulated_bwd_dkv(*args)
    _assert_within(dq_emu, dq_plain, tol["grad"], "dq")
    _assert_within(dk_emu, dk_plain, tol["grad"], "dk")
    _assert_within(dv_emu, dv_plain, tol["grad"], "dv")

    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o_j, lse_j = jfa._fwd(jq, jk, jv, causal=True, scale=scale, block_q=s // 4,
                          block_k=s // 4, interpret=True)
    dq_j, dk_j, dv_j = jfa._bwd(jq, jk, jv, o_j, lse_j, jdo, causal=True, scale=scale,
                                block_q=s // 4, block_k=s // 4, interpret=True)
    for got, want, what in ((o_emu, o_j, "O"), (dq_emu, dq_j, "dq"), (dk_emu, dk_j, "dk"),
                            (dv_emu, dv_j, "dv")):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2, err_msg=f"{what} vs the JAX kernel")


@pytest.mark.parametrize("s_q,s_k,dtype", [(72, 72, jnp.float32), (64, 32, jnp.float32),
                                           (200, 72, jnp.bfloat16)])
def test_dq_plain_delta_matches_the_jax_einsum(s_q, s_k, dtype):
    """Δ of ``flash_bwd_dq_plain`` against the einsum in the JAX ``_bwd``
    (f32, 1e-6) on a ragged length and on causal rows that see no key (Δ and
    dq exactly 0 there), and its dq against ``_bwd``'s dq, all from the same
    Pallas forward in interpret mode."""
    rng = np.random.default_rng(7)
    bh, d = 4, 32
    q, do = (rng.standard_normal((bh, s_q, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((bh, s_k, d), dtype=np.float32) for _ in range(2))
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    o_j, lse_j = jfa._fwd(jq, jk, jv, causal=True, scale=scale, block_q=s_q, block_k=s_k,
                          interpret=True)
    want = jnp.einsum("bsd,bsd->bs", jdo.astype(jnp.float32), o_j.astype(jnp.float32))
    dq_j, _, _ = jfa._bwd(jq, jk, jv, o_j, lse_j, jdo, causal=True, scale=scale,
                          block_q=s_q, block_k=s_k, interpret=True)

    t_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tq, tk, tv, tdo, to = (torch.from_numpy(np.array(x, np.float32)).to(t_dtype)
                           for x in (jq, jk, jv, jdo, o_j))
    lse = torch.from_numpy(np.array(lse_j)[..., 0])
    dq, delta = tfa.flash_bwd_dq_plain(tq, tk, tv, to, tdo, lse, True, scale)
    assert delta.dtype == torch.float32 and delta.shape == (bh, s_q)
    np.testing.assert_allclose(delta.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    n_dead = max(s_q - s_k, 0)
    assert n_dead == 0 or not (delta[:, :n_dead].any() or dq[:, :n_dead].any())
    tol = 5e-4 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(dq.float().numpy(), np.asarray(dq_j, np.float32),
                               atol=tol, rtol=tol)


def test_bounds_reproduce_the_recorded_main_shape_bounds():
    """``chip_smoke.bound`` at [128, 1024, 64] bf16 causal against 989 TFLOP/s
    and 3.35 TB/s: 0.0202 ms (fwd, bytes), 0.0304 (dq, bytes: it reads O
    and writes Δ, which Δ's fusion made part of its work), 0.0348 (dkv,
    operations), the bounds PERF.md records."""
    smoke = _chip_smoke()
    assert smoke.visible_pairs(1024, 1024, True) == 1024 * 1025 // 2
    assert smoke.visible_pairs(200, 72, True) == sum(range(1, 73))  # 128 dead rows
    assert smoke.visible_pairs(64, 32, False) == 64 * 32
    want = {"flash_fwd": (0.0202, "bytes"), "flash_bwd_dq": (0.0304, "bytes"),
            "flash_bwd_dkv": (0.0348, "operations")}
    for name, (ms, by) in want.items():
        got_ms, got_by = smoke.bound(name, 128, 1024, 1024, 64, True, 2, 989e12)
        assert (round(got_ms, 4), got_by) == (ms, by), name


# ---------------------------------------------------------------------------
# the f32 backward kernels' 3xTF32 products
# ---------------------------------------------------------------------------

def _as_f32(bits: int) -> torch.Tensor:
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0: already TF32
    (0x3F800FFF, 0x3F800000),  # below half a TF32 ulp: down
    (0x3F801001, 0x3F802000),  # above it: up
    (0x3F801000, 0x3F802000),  # a tie on an even TF32 mantissa: away from zero (not to even)
    (0xBF801000, 0xBF802000),  # the same tie, negative: away from zero
    (0x3F805000, 0x3F806000),  # a tie on an even mantissa above: away (to even gives 0x3F804000)
    (0x3F803000, 0x3F804000),  # a tie on an odd mantissa: away
    (0x3FFFF000, 0x40000000),  # the carry runs into the exponent: 2.0
    (0x00001000, 0x00002000),  # a subnormal tie: away
    (0x7F800000, 0x7F800000),  # +inf passes through
    (0xFF800000, 0xFF800000),  # -inf passes through
    (0x7FC00123, 0x7FC00123),  # nan passes through, payload and all
])
def test_tf32_round_is_cvt_rna(bits, want):
    """``chip_smoke.tf32_round`` (the planted fault of the f32 backward
    check) rounds as ``cvt.rna.tf32.f32``: to the nearest of the values with
    10 explicit mantissa bits, ties away from zero; inf and nan pass
    through."""
    got = _chip_smoke().tf32_round(_as_f32(bits)).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, f"{bits:#010x} -> {got:#010x}, want {want:#010x}"


def _three_tf32_product(a: np.ndarray, b: np.ndarray, tf32_round) -> np.ndarray:
    """a·b as the f32 backward kernels form it: each operand split into
    big = TF32 round-to-nearest and small = x − big (exact in f32), whose
    low 13 bits the tensor core ignores; small·big + big·small + big·big,
    each product exact (TF32 times TF32 fits f32) and summed in f32."""
    def split(x):
        big = tf32_round(torch.from_numpy(x)).numpy()
        small = (x - big).view(np.int32) & np.int32(-0x2000)
        return big, small.view(np.float32)

    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_products_keep_f32_accuracy(seed):
    """On seeded [64, 64] f32 matrices the 3xTF32 product lies within 1e-6
    of the f64 product in relative L2 (f32's own product reads ~1.5e-7),
    and one TF32 product of the rounded operands, the planted fault of
    ``chip_smoke.F32_GRAD_REL``, at least 10x further (it reads ~2.9e-4)."""
    tf32_round = _chip_smoke().tf32_round
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal((64, 64), dtype=np.float32) for _ in range(2))
    exact = a.astype(np.float64) @ b.astype(np.float64)

    def rel(x):
        return float(np.linalg.norm(x - exact) / np.linalg.norm(exact))

    three = rel(_three_tf32_product(a, b, tf32_round))
    one = rel(tf32_round(torch.from_numpy(a)).numpy() @ tf32_round(torch.from_numpy(b)).numpy())
    assert three <= 1e-6, three
    assert one >= 10 * three, (one, three)


@pytest.mark.parametrize("name,fp32_ms,tf32x3_ms", [("flash_fwd", 0.0962, 0.0390),
                                                    ("flash_bwd_dq", 0.1443, 0.0586),
                                                    ("flash_bwd_dkv", 0.1923, 0.0781)])
def test_f32_bounds_at_bert_base_shape(name, fp32_ms, tf32x3_ms):
    """``chip_smoke.bound`` at BERT-base's [96, 512, 512, 64] f32
    non-causal, at the CUDA cores' 67 TFLOP/s and at 3xTF32's 495/3: the
    bounds PERF.md records, all by operations."""
    smoke = _chip_smoke()
    for rate, ms in ((smoke.F32_PEAK_FLOPS, fp32_ms), (smoke.TF32X3_PEAK_FLOPS, tf32x3_ms)):
        got_ms, got_by = smoke.bound(name, 96, 512, 512, 64, False, 4, rate)
        assert (round(got_ms, 4), got_by) == (ms, "operations"), (name, rate)


def _forward(q, k, v, product):
    """O as the f32 forward kernel forms it, over key tiles of 64: S =
    Q·Kᵀ and O += P·V by ``product(c, a, b)`` (c + a·b), the online softmax
    in f32 in the log2 domain (running max, P = exp2(S·scale·log2e − max),
    the sum and O rescaled by exp2(old max − new max)), O = acc / l."""
    scale, log2e = np.float32(q.shape[1] ** -0.5), np.float32(np.log2(np.e))
    m = np.full((q.shape[0], 1), -np.inf, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros((q.shape[0], v.shape[1]), np.float32)
    for k0 in range(0, k.shape[0], 64):
        kt, vt = k[k0:k0 + 64], v[k0:k0 + 64]
        s = product(np.zeros((q.shape[0], len(kt)), np.float32), q, np.ascontiguousarray(kt.T))
        s = s * scale * log2e
        mx = np.maximum(m, s.max(1, keepdims=True))
        p, corr = np.exp2(s - mx).astype(np.float32), np.exp2(m - mx).astype(np.float32)
        l = l * corr + p.sum(1, keepdims=True)
        acc = product(acc * corr, p, vt)
        m = mx
    return acc / l


def _softmax_v(q, k, v):
    """softmax(q·kᵀ·scale)·v in f64."""
    s = (q.astype(np.float64) @ k.astype(np.float64).T) * q.shape[1] ** -0.5
    p = np.exp(s - s.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v.astype(np.float64)


def _rel(x, exact):
    return float(np.linalg.norm(x - exact) / np.linalg.norm(exact))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_online_softmax_keeps_f32_accuracy(seed):
    """The f32 forward kernel's arithmetic, each product's sum rounded to
    nearest in f32, on seeded [64 rows, 192 keys, 64] f32 inputs in three
    key tiles of 64: O within 1e-6 of the f64 softmax(q·kᵀ·scale)·v in
    relative L2, and the same arithmetic on q, k and v rounded to TF32, the
    planted fault of ``chip_smoke.F32_FWD_REL``, at least 10x further."""
    tf32_round = _chip_smoke().tf32_round
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((n, 64), dtype=np.float32) for n in (64, 192, 192))
    exact = _softmax_v(q, k, v)

    def product(c, a, b):
        return c + _three_tf32_product(a, b, tf32_round)

    def rounded(x):
        return tf32_round(torch.from_numpy(x)).numpy()

    sound = _rel(_forward(q, k, v, product), exact)
    fault = _rel(_forward(rounded(q), rounded(k), rounded(v), product), exact)
    assert sound <= 1e-6, sound
    assert fault >= 10 * sound, (fault, sound)


def _truncated(x: np.ndarray) -> np.ndarray:
    """f64 values to f32, truncated toward zero."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x), np.nextafter(f, np.float32(0)), f)


def _tensor_core_three_tf32(c, a, b, tf32_round, step):
    """c + a·b in 3xTF32 over k8 steps, each ``mma.sync`` modelled as the
    tensor core's: its exact products added to the accumulator and the sum
    truncated toward zero to f32. ``step``: each step's three products
    summed from 0 and added to c in f32, rounded to nearest (the f32 forward
    kernel's order); else all summed in c itself."""
    def split(x):
        big = tf32_round(torch.from_numpy(np.ascontiguousarray(x))).numpy()
        small = (x - big).view(np.int32) & np.int32(-0x2000)
        return big.astype(np.float64), small.view(np.float32).astype(np.float64)

    c = c.astype(np.float32)
    for k0 in range(0, a.shape[1], 8):
        (a_big, a_small), (b_big, b_small) = split(a[:, k0:k0 + 8]), split(b[k0:k0 + 8])
        d = np.zeros(c.shape, np.float32) if step else c
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            d = _truncated(d.astype(np.float64) + x @ y)
        c = (c + d).astype(np.float32) if step else d
    return c


def test_per_step_sums_keep_the_forward_accurate_on_truncating_tensor_cores():
    """The f32 forward kernel's arithmetic on seeded [64 rows, 512 keys, 64]
    f32 inputs in key tiles of 64, its products modelled as the tensor core
    forms them (each ``mma.sync`` truncates its sum toward zero). Each k8
    step summed apart and added in f32, as the kernel does, keeps O within
    5e-7 of the f64 softmax·V in relative L2; the same products summed in
    one running accumulator drift at least 4x further (the card read 4.0e-6
    for that order at BERT-base's shape)."""
    tf32_round = _chip_smoke().tf32_round
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((n, 64), dtype=np.float32) for n in (64, 512, 512))
    exact = _softmax_v(q, k, v)

    def forward(step):
        return _forward(q, k, v, lambda c, a, b: _tensor_core_three_tf32(c, a, b, tf32_round,
                                                                          step))

    per_step, running = _rel(forward(True), exact), _rel(forward(False), exact)
    assert per_step <= 5e-7, per_step
    assert running >= 4 * per_step, (running, per_step)


def test_every_f32_kernel_is_built_and_held_to_tf32_sass():
    """Each f32 kernel that ``flash_attention`` counts has its source in
    ``chip_smoke.SOURCE`` (a file of ``KERNEL_SOURCES`` that defines the
    kernel) and an entry in ``chip_smoke.TC_KERNELS`` that demands TF32
    ``mma.sync`` in its SASS, so that phase 2 fails its build if it spills
    or runs on the CUDA cores."""
    from easydl_tpu_torch.ops import build

    smoke = _chip_smoke()
    for name in tfa.KERNELS[torch.float32]:
        kernel = name + "_sm90_kernel"
        source = smoke.SOURCE[name]
        assert source.startswith(smoke.CSRC), (name, source)
        assert source[len(smoke.CSRC):] in tfa.KERNEL_SOURCES, (name, source)
        assert kernel in (build.CSRC / source[len(smoke.CSRC):]).read_text(), (name, source)
        assert smoke.TC_KERNELS[kernel] == smoke.F32_SASS, kernel
