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
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


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
