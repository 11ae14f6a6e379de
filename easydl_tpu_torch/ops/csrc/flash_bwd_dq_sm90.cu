// Flash attention dq for Hopper tensor cores, bf16 (head_dim 32, 64), with
// Δ = rowsum(dO∘O) computed in the kernel.
//
// Replaces _bwd_dq_kernel of easydl_tpu/ops/flash_attention.py (the first
// pallas_call in _bwd) and the einsum for Δ in front of it, on the bf16
// path; the f32 path keeps the exact-f32 kernel of flash_attention.cu. Same
// interface and results: dq from q, k, v, dO and the forward's natural-log
// lse, and Δ from dO and O, written out for the dk/dv kernel; rows with
// lse = +FLT_MAX (they saw no key) get dq = 0 exactly; the causal mask is
// bottom-right aligned; any s_q and s_k run here.
//
// What bounds it. At the GPT-2 345M shape a call moves 102 MB (q, k, v, O,
// dO in; dq out) and does 26 GFLOP, so the card could finish it in ~30 us,
// bound by bytes with the operations close behind (~26 us): the three
// products have to run on the tensor cores, and the K and V tiles that
// every q-tile of a head reads again come from L2.
//
// Design: one CTA per (head, 128-row q-tile), heaviest causal tiles first.
// Two warpgroups own 64 rows each; Q and dO stay in shared memory for the
// whole loop (TMA), and the 64-row K and V tiles stream through a ring of
// STAGES slots, each guarded by a full and an empty mbarrier; thread 0
// refills a slot as soon as both warpgroups have released it (no producer
// warp: a ninth warp caps ptxas's registers, see flash_bwd_dkv_sm90.cu).
// Two CTAs share an SM: ptxas fits the kernel into 122 registers without
// spills when asked to (132 when not, one CTA an SM), and on an H100 SXM at
// the main shape that ran in 0.095 ms instead of 0.113.
// Prologue: O comes in once by TMA beside Q and dO, and each warpgroup
// sums dO∘O over its rows in f32 (the TMA swizzle permutes 16-byte chunks
// within a row, alike in both tiles, so the products pair up as they lie);
// a row's four threads reduce with two shuffles and one writes Δ. Per key
// tile a warpgroup computes S = Q·Kᵀ and dP = dO·Vᵀ with wgmma (both
// operands K-major in shared memory), forms P = exp(scale·S − lse) and
// dS = P∘(dP − Δ) in registers (f32, log2 domain; the mask only on tiles
// that cross the diagonal or the key tail), rounds dS to bf16 and
// accumulates dq += dS·K as a register-A wgmma, reading the same K tile
// MN-major. dq stays in registers to the end, the scale is applied in the
// f32 epilogue.

#include "sm90_common.cuh"

namespace {

constexpr int DQ_BQ = 2 * TILE;  // rows per CTA: two warpgroups
constexpr int DQ_STAGES = 2;
constexpr int DQ_THREADS = 2 * 128;

template <int D>
struct DqSmem {
  bf16 q[DQ_BQ * D];
  bf16 dout[DQ_BQ * D];
  bf16 o[DQ_BQ * D];  // read in the prologue only
  bf16 k[DQ_STAGES][TILE * D];
  bf16 v[DQ_STAGES][TILE * D];
  uint64_t q_full, full[DQ_STAGES], empty[DQ_STAGES];
};

// Σ of the products of eight bf16 pairs, in f32.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    sum = fmaf(u.x, w.x, sum);
    sum = fmaf(u.y, w.y, sum);
  }
  return sum;
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 2)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_o,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         bf16* __restrict__ dq, int s_q, int s_k, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = aligned_smem<DqSmem<D>>(smem_raw);
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;
  const int n_k = max(live_key_tiles(q0, TILE, s_q, s_k, causal),
                      live_key_tiles(q0 + TILE, TILE, s_q, s_k, causal));
  const bool loader = threadIdx.x == 0;
  // K/V tile i into its slot; completes on the slot's full barrier
  auto load_kv = [&](int i) {
    const int s = i % DQ_STAGES;
    mbar_expect_tx(&sm.full[s], 2 * TILE * D * sizeof(bf16));
    tma_load(sm.k[s], &tm_k, &sm.full[s], i * TILE, bh);
    tma_load(sm.v[s], &tm_v, &sm.full[s], i * TILE, bh);
  };

  if (loader) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], DQ_THREADS);
    }
    mbar_init_fence();
    mbar_expect_tx(&sm.q_full, 3 * DQ_BQ * D * sizeof(bf16));
    for (int h = 0; h < 2; ++h) {
      tma_load(sm.q + h * TILE * D, &tm_q, &sm.q_full, q0 + h * TILE, bh);
      tma_load(sm.dout + h * TILE * D, &tm_do, &sm.q_full, q0 + h * TILE, bh);
      tma_load(sm.o + h * TILE * D, &tm_o, &sm.q_full, q0 + h * TILE, bh);
    }
    for (int i = 0; i < min(n_k, DQ_STAGES); ++i) load_kv(i);
  }
  __syncthreads();

  // warpgroup wg: rows row0 + [0, 64); this thread holds rows row0 + r and
  // row0 + r + 8, columns 8j + c + {0, 1}
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
  const int row0 = q0 + wg * TILE;
  const int offset = s_k - s_q;
  const int n_live = live_key_tiles(row0, TILE, s_q, s_k, causal);
  const float scale_log2 = scale * LOG2E;
  lse += (int64_t)bh * s_q;
  delta += (int64_t)bh * s_q;

  float lse2[2];  // log2 units; +FLT_MAX past s_q makes P exactly 0 there
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    lse2[h] = row < s_q ? lse[row] * LOG2E : FLT_MAX;
  }

  mbar_wait(&sm.q_full, 0);
  float dl[2];  // Δ of rows r and r + 8; 0 past s_q, where TMA filled zeros
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int at = (wg * TILE + r + 8 * h) * D;
    const uint4* d_row = reinterpret_cast<const uint4*>(sm.dout + at);
    const uint4* o_row = reinterpret_cast<const uint4*>(sm.o + at);
    float sum = 0.f;
#pragma unroll
    for (int j = t % 4; j < D / 8; j += 4) sum += dot8(d_row[j], o_row[j]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[h] = sum;
    const int row = row0 + r + 8 * h;
    if (c == 0 && row < s_q) delta[row] = sum;
  }

  float acc_dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;
  const uint64_t desc_q = smem_desc<D>(sm.q + wg * TILE * D);
  const uint64_t desc_do = smem_desc<D>(sm.dout + wg * TILE * D);

  for (int i = 0; i < n_k; ++i) {
    const int s = i % DQ_STAGES;
    mbar_wait(&sm.full[s], (i / DQ_STAGES) & 1);
    if (i < n_live) {
      const uint64_t desc_k = smem_desc<D>(sm.k[s]), desc_v = smem_desc<D>(sm.v[s]);
      float acc_s[32], acc_dp[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss(acc_s, desc_q + k_major_step(kc), desc_k + k_major_step(kc), kc > 0);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss(acc_dp, desc_do + k_major_step(kc), desc_v + k_major_step(kc), kc > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_s);
      fence_regs(acc_dp);

      // the tile crosses the key tail or the causal diagonal: K rows past s_k
      // were filled with zeros, which would give P = exp(−lse) there
      const int k0 = i * TILE;
      const bool masked = k0 + TILE > s_k || (causal && k0 + TILE - 1 > row0 + offset);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * h + e;
            float p = exp2f(acc_s[idx] * scale_log2 - lse2[h]);
            if (masked) {
              const int row = row0 + r + 8 * h, col = k0 + 8 * j + c + e;
              if (col >= s_k || (causal && row + offset < col)) p = 0.f;
            }
            acc_s[idx] = p * (acc_dp[idx] - dl[h]);  // dS
          }

      uint32_t ds_frag[4][4];
      to_a_fragments(acc_s, ds_frag);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs(acc_dq, ds_frag[kc], desc_k + mn_major_step<D>(kc));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_dq);
    }
    mbar_arrive(&sm.empty[s]);
    if (loader && i + DQ_STAGES < n_k) {  // refill the slot once both warpgroups left it
      mbar_wait(&sm.empty[s], (i / DQ_STAGES) & 1);
      load_kv(i + DQ_STAGES);
    }
    __syncwarp();
  }

  dq += (int64_t)bh * s_q * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    if (row >= s_q) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + (int64_t)row * D + 8 * j + c) =
          __floats2bfloat162_rn(acc_dq[4 * j + 2 * h] * scale, acc_dq[4 * j + 2 * h + 1] * scale);
  }
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, int bh, int s_q, int s_k, int causal,
                   float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o, tm_do;
  cudaError_t err;
  if ((err = make_map<D>(&tm_q, q, bh, s_q)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_k, k, bh, s_k)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_v, v, bh, s_k)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_o, o, bh, s_q)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_do, dout, bh, s_q)) != cudaSuccess) return err;
  const size_t smem = sizeof(DqSmem<D>) + 1024;
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  static const cudaError_t set = set_smem(kernel, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((s_q + DQ_BQ - 1) / DQ_BQ, bh);
  kernel<<<grid, DQ_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_o, tm_do, (const float*)lse,
                                             (float*)delta, (bf16*)dq, s_q, s_k, causal, scale);
  return cudaGetLastError();
}

template <int D>
int dq_ctas_per_sm() {
  int n = 0;
  const size_t smem = sizeof(DqSmem<D>) + 1024;
  if (set_smem(flash_bwd_dq_sm90_kernel<D>, smem) != cudaSuccess) return -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_bwd_dq_sm90_kernel<D>, DQ_THREADS, smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// CTAs of the dq kernel that fit on one SM (-1 on error).
int flash_bwd_dq_sm90_ctas_per_sm(int head_dim) {
  return head_dim == 32 ? dq_ctas_per_sm<32>() : head_dim == 64 ? dq_ctas_per_sm<64>() : -1;
}

// bf16 dq and Δ, head_dim 32 or 64 (else cudaErrorInvalidValue).
cudaError_t flash_bwd_dq_sm90(int head_dim, const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const void* lse, void* delta,
                              void* dq, int bh, int s_q, int s_k, int causal, float scale,
                              cudaStream_t stream) {
  if (head_dim == 32)
    return bwd_dq<32>(q, k, v, o, dout, lse, delta, dq, bh, s_q, s_k, causal, scale, stream);
  if (head_dim == 64)
    return bwd_dq<64>(q, k, v, o, dout, lse, delta, dq, bh, s_q, s_k, causal, scale, stream);
  return cudaErrorInvalidValue;
}
