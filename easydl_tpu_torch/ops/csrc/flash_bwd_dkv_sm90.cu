// Flash attention dk/dv for Hopper tensor cores, bf16 (head_dim 32, 64).
//
// Replaces _bwd_dkv_kernel of easydl_tpu/ops/flash_attention.py (the second
// pallas_call in _bwd) on the bf16 path; the f32 path has the 3xTF32
// kernel of flash_bwd_f32_sm90.cu. Same interface and results: dk and dv from
// q, k, v, dO, the forward's natural-log lse and Δ = rowsum(dO∘O); rows with
// lse = +FLT_MAX (they saw no key) contribute exactly nothing; the causal
// mask is bottom-right aligned; any s_q and s_k run here.
//
// What bounds it. At the GPT-2 345M shape a call does 34 GFLOP against
// 67 MB, so the card could finish it in ~35 us, bound by operations: the
// four products have to run on the tensor cores.
//
// Design: one CTA per (head, 128-key tile); two warpgroups own 64 keys each
// and keep K and V in shared memory for the whole loop. The 64-row q-tiles
// that can see the keys stream through a ring of STAGES slots (Q and dO by
// TMA, lse and Δ by the lanes of warp 0, padded with +FLT_MAX and 0 past
// s_q); warp 0 refills a slot as soon as both warpgroups have released it.
// There is no producer warp: a CTA of 8 warps may hold 255 registers a
// thread, and a warpgroup holds dk, dv, Sᵀ and dPᵀ (128 f32) at once; with
// a ninth warp ptxas caps the CTA at 168 and spills (setmaxnreg does not
// lift that cap at compile time). Per q-tile a warpgroup computes
// the transposed products Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with wgmma, so key rows
// are the accumulator's rows; forms Pᵀ = exp(scale·Sᵀ − lse[col]) and
// dSᵀ = Pᵀ∘(dPᵀ − Δ[col]) in registers (f32, log2 domain); rounds both to
// bf16 and accumulates dV += Pᵀ·dO and dK += dSᵀ·Q as register-A wgmmas
// with dO and Q as the shared-memory B operand. dk and dv stay in registers
// to the end, and the scale is applied to dk in the f32 epilogue: no round
// trip through shared memory and no atomics. Causal q-tiles wholly before
// the diagonal are never loaded; the mask is applied only on tiles that
// cross it.

#include "sm90_common.cuh"

namespace {

constexpr int DKV_BK = 2 * TILE;  // keys per CTA: two warpgroups
constexpr int DKV_STAGES = 2;
constexpr int DKV_THREADS = 2 * 128;

template <int D>
struct DkvSmem {
  bf16 k[DKV_BK * D];
  bf16 v[DKV_BK * D];
  bf16 q[DKV_STAGES][TILE * D];
  bf16 dout[DKV_STAGES][TILE * D];
  float lse[DKV_STAGES][TILE];  // log2 units
  float delta[DKV_STAGES][TILE];
  uint64_t kv_full, full[DKV_STAGES], empty[DKV_STAGES];
};

// First q-tile whose rows can see key `key` (causal: row + offset >= key).
__device__ __forceinline__ int first_q_tile(int key, int offset, int causal) {
  return causal ? max(0, key - offset) / TILE : 0;
}

// Warp 0: loads q-tile `qt` into slot s (Q and dO by TMA from lane 0, lse
// and Δ by the 32 lanes) and arrives on the slot's full barrier.
template <int D>
__device__ __forceinline__ void load_q_tile(DkvSmem<D>& sm, int s, int qt, int bh,
                                            const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const float* lse, const float* delta, int s_q) {
  const int lane = threadIdx.x % 32, row0 = qt * TILE;
  if (lane == 0) {
    mbar_expect_tx(&sm.full[s], 2 * TILE * D * sizeof(bf16));
    tma_load(sm.q[s], tm_q, &sm.full[s], row0, bh);
    tma_load(sm.dout[s], tm_do, &sm.full[s], row0, bh);
  }
  for (int j = lane; j < TILE; j += 32) {
    const int row = row0 + j;
    // +FLT_MAX past the end makes exp(s - lse) exactly 0 there
    sm.lse[s][j] = row < s_q ? lse[row] * LOG2E : FLT_MAX;
    sm.delta[s][j] = row < s_q ? delta[row] : 0.f;
  }
  mbar_arrive(&sm.full[s]);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int s_q, int s_k,
                          int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<D>& sm = aligned_smem<DkvSmem<D>>(smem_raw);
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * DKV_BK;
  const int offset = s_k - s_q;
  const int n_q = (s_q + TILE - 1) / TILE;
  const int first_q = min(n_q, first_q_tile(k0, offset, causal));
  const int n_iter = n_q - first_q;
  const bool loader = threadIdx.x < 32;
  lse += (int64_t)bh * s_q;
  delta += (int64_t)bh * s_q;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&sm.full[s], 1 + 32);  // the TMA's expect_tx and warp 0's 32 lanes
      mbar_init(&sm.empty[s], DKV_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (loader) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * DKV_BK * D * sizeof(bf16));
      for (int h = 0; h < 2; ++h) {
        tma_load(sm.k + h * TILE * D, &tm_k, &sm.kv_full, k0 + h * TILE, bh);
        tma_load(sm.v + h * TILE * D, &tm_v, &sm.kv_full, k0 + h * TILE, bh);
      }
    }
    for (int i = 0; i < min(n_iter, DKV_STAGES); ++i)
      load_q_tile<D>(sm, i, first_q + i, bh, &tm_q, &tm_do, lse, delta, s_q);
  }

  // warpgroup wg: keys key0 + [0, 64); this thread holds key rows key0 + r
  // and key0 + r + 8, q columns 8j + c + {0, 1} of each q-tile
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
  const int key0 = k0 + wg * TILE;
  const int first_live = key0 < s_k ? first_q_tile(key0, offset, causal) : n_q;
  const float scale_log2 = scale * LOG2E;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(&sm.kv_full, 0);
  const uint64_t desc_k = smem_desc<D>(sm.k + wg * TILE * D);
  const uint64_t desc_v = smem_desc<D>(sm.v + wg * TILE * D);

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % DKV_STAGES, qt = first_q + i, row0 = qt * TILE;
    mbar_wait(&sm.full[s], (i / DKV_STAGES) & 1);
    if (qt >= first_live) {
      const uint64_t desc_q = smem_desc<D>(sm.q[s]), desc_do = smem_desc<D>(sm.dout[s]);
      float acc_s[32], acc_dp[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss(acc_s, desc_k + k_major_step(kc), desc_q + k_major_step(kc), kc > 0);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss(acc_dp, desc_v + k_major_step(kc), desc_do + k_major_step(kc), kc > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_s);
      fence_regs(acc_dp);

      // some (row, key) pair of this tile is hidden: row0 + offset < key0 + 63
      const bool masked = causal && row0 + offset < key0 + TILE - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + c + e;
          const float lse2 = sm.lse[s][col], dl = sm.delta[s][col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 4 * j + 2 * h + e;
            float p = exp2f(acc_s[idx] * scale_log2 - lse2);
            if (masked && row0 + col + offset < key0 + r + 8 * h) p = 0.f;
            acc_s[idx] = p;
            acc_dp[idx] = p * (acc_dp[idx] - dl);
          }
        }

      uint32_t p_frag[4][4], ds_frag[4][4];
      to_a_fragments(acc_s, p_frag);
      to_a_fragments(acc_dp, ds_frag);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs(acc_dv, p_frag[kc], desc_do + mn_major_step<D>(kc));
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs(acc_dk, ds_frag[kc], desc_q + mn_major_step<D>(kc));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    mbar_arrive(&sm.empty[s]);
    if (loader && i + DKV_STAGES < n_iter) {  // refill the slot once both warpgroups left it
      mbar_wait(&sm.empty[s], (i / DKV_STAGES) & 1);
      load_q_tile<D>(sm, s, qt + DKV_STAGES, bh, &tm_q, &tm_do, lse, delta, s_q);
    }
    __syncwarp();
  }

  dk += (int64_t)bh * s_k * D;
  dv += (int64_t)bh * s_k * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + r + 8 * h;
    if (key >= s_k) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int64_t at = (int64_t)key * D + 8 * j + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          acc_dk[4 * j + 2 * h] * scale, acc_dk[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * h], acc_dv[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int s_q,
                    int s_k, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err;
  if ((err = make_map<D>(&tm_q, q, bh, s_q)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_k, k, bh, s_k)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_v, v, bh, s_k)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_do, dout, bh, s_q)) != cudaSuccess) return err;
  const size_t smem = sizeof(DkvSmem<D>) + 1024;
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  static const cudaError_t set = set_smem(kernel, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((s_k + DKV_BK - 1) / DKV_BK, bh);
  kernel<<<grid, DKV_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, (const float*)lse,
                                              (const float*)delta, (bf16*)dk, (bf16*)dv, s_q,
                                              s_k, causal, scale);
  return cudaGetLastError();
}

template <int D>
int dkv_ctas_per_sm() {
  int n = 0;
  const size_t smem = sizeof(DkvSmem<D>) + 1024;
  if (set_smem(flash_bwd_dkv_sm90_kernel<D>, smem) != cudaSuccess) return -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_bwd_dkv_sm90_kernel<D>, DKV_THREADS, smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// CTAs of the dk/dv kernel that fit on one SM (-1 on error).
int flash_bwd_dkv_sm90_ctas_per_sm(int head_dim) {
  return head_dim == 32 ? dkv_ctas_per_sm<32>() : head_dim == 64 ? dkv_ctas_per_sm<64>() : -1;
}

// bf16 dk and dv, head_dim 32 or 64 (else cudaErrorInvalidValue).
cudaError_t flash_bwd_dkv_sm90(int head_dim, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta, void* dk,
                               void* dv, int bh, int s_q, int s_k, int causal, float scale,
                               cudaStream_t stream) {
  if (head_dim == 32)
    return bwd_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_k, causal, scale, stream);
  if (head_dim == 64)
    return bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_k, causal, scale, stream);
  return cudaErrorInvalidValue;
}
