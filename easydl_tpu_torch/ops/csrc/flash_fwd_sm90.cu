// Flash attention forward for Hopper tensor cores, bf16 (head_dim 32, 64).
//
// Replaces _fwd_kernel of easydl_tpu/ops/flash_attention.py (its pallas_call
// in _fwd) on the bf16 path; the f32 path has the 3xTF32 kernel of
// flash_fwd_f32_sm90.cu. Same interface and results: O (bf16) and the
// natural-log row logsumexp lse (f32); a row that sees no key writes O = 0
// and lse = +FLT_MAX; the causal mask is bottom-right aligned; any s_q and
// s_k run here, the tails masked in-kernel.
//
// What bounds it. At the GPT-2 345M shape ([128, 1024, 64], causal) a call
// does 17 GFLOP against 50 MB, so the card could finish it in ~20 us, bound
// by bytes; the products decide how close it gets, and they run only on
// the tensor cores through wgmma.
//
// Design: one CTA per (head, 128-row q-tile), heaviest causal tiles first.
// Two warpgroups own 64 rows each; the 64-row K and V tiles stream through a
// ring of STAGES slots in shared memory by TMA, each slot guarded by a full
// and an empty mbarrier, and thread 0 refills a slot as soon as both
// warpgroups have released it. (A separate producer warp was tried first: a
// ninth warp caps two CTAs an SM at 96 registers, which spills, so one CTA
// ran per SM, at 0.105 ms on the main shape on an H100 SXM; without it two
// CTAs of 106 registers share an SM, at 0.091 ms.) Per K/V tile a warpgroup computes S = Q·Kᵀ with wgmma (both operands in shared
// memory, f32 accumulate), runs the online softmax on the accumulator in
// registers in the log2 domain (scale·log2e applied to S in f32; rows are
// reduced across a quad with two shuffles; S never goes to shared memory),
// rounds P to bf16 in registers and feeds it as the register-A operand of
// O += P·V. The row sum l is taken from the unrounded P. O and lse are
// written from registers in the epilogue.

#include "sm90_common.cuh"

namespace {

constexpr int FWD_BQ = 2 * TILE;  // rows per CTA: two consumer warpgroups
constexpr int FWD_STAGES = 2;
constexpr int FWD_THREADS = 2 * 128;  // two warpgroups

template <int D>
struct FwdSmem {
  bf16 q[FWD_BQ * D];
  bf16 k[FWD_STAGES][TILE * D];
  bf16 v[FWD_STAGES][TILE * D];
  uint64_t q_full, full[FWD_STAGES], empty[FWD_STAGES];
};

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                      float* __restrict__ lse, int s_q, int s_k, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<D>& sm = aligned_smem<FwdSmem<D>>(smem_raw);
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_BQ;
  const int n_k = max(live_key_tiles(q0, TILE, s_q, s_k, causal),
                      live_key_tiles(q0 + TILE, TILE, s_q, s_k, causal));
  const bool loader = threadIdx.x == 0;
  // K/V tile i into its slot; completes on the slot's full barrier
  auto load_kv = [&](int i) {
    const int s = i % FWD_STAGES;
    mbar_expect_tx(&sm.full[s], 2 * TILE * D * sizeof(bf16));
    tma_load(sm.k[s], &tm_k, &sm.full[s], i * TILE, bh);
    tma_load(sm.v[s], &tm_v, &sm.full[s], i * TILE, bh);
  };

  if (loader) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], FWD_THREADS);
    }
    mbar_init_fence();
    mbar_expect_tx(&sm.q_full, FWD_BQ * D * sizeof(bf16));
    tma_load(sm.q, &tm_q, &sm.q_full, q0, bh);
    tma_load(sm.q + TILE * D, &tm_q, &sm.q_full, q0 + TILE, bh);
    for (int i = 0; i < min(n_k, FWD_STAGES); ++i) load_kv(i);
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

  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running row max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum

  mbar_wait(&sm.q_full, 0);
  const uint64_t desc_q = smem_desc<D>(sm.q + wg * TILE * D);

  for (int i = 0; i < n_k; ++i) {
    const int s = i % FWD_STAGES;
    mbar_wait(&sm.full[s], (i / FWD_STAGES) & 1);
    if (i < n_live) {
      float acc_s[32];
      const uint64_t desc_k = smem_desc<D>(sm.k[s]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss(acc_s, desc_q + k_major_step(kc), desc_k + k_major_step(kc), kc > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_s);

      const int k0 = i * TILE;
      const bool masked = k0 + TILE > s_k || (causal && k0 + TILE - 1 > row0 + offset);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * h + e;
            float x = acc_s[idx] * scale_log2;
            if (masked) {
              const int row = row0 + r + 8 * h, col = k0 + 8 * j + c + e;
              if (col >= s_k || (causal && row + offset < col)) x = NEG_INF;
            }
            acc_s[idx] = x;
            mx[h] = fmaxf(mx[h], x);
          }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * h + e;
            const float p = exp2f(acc_s[idx] - m[h]);
            acc_s[idx] = p;
            l[h] += p;
          }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc_o[4 * j + 2 * h] *= corr[h];
          acc_o[4 * j + 2 * h + 1] *= corr[h];
        }

      uint32_t p_frag[4][4];
      to_a_fragments(acc_s, p_frag);
      const uint64_t desc_v = smem_desc<D>(sm.v[s]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs(acc_o, p_frag[kc], desc_v + mn_major_step<D>(kc));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_o);
    }
    mbar_arrive(&sm.empty[s]);
    if (loader && i + FWD_STAGES < n_k) {  // refill the slot once both warpgroups left it
      mbar_wait(&sm.empty[s], (i / FWD_STAGES) & 1);
      load_kv(i + FWD_STAGES);
    }
    __syncwarp();
  }

  o += (int64_t)bh * s_q * D;
  lse += (int64_t)bh * s_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + r + 8 * h;
    if (row >= s_q) continue;
    // A row that saw no visible key still has m at the sentinel: zero output.
    const bool dead = m[h] <= NEG_INF * 0.5f;
    sum = fmaxf(sum, 1e-30f);
    const float inv = dead ? 0.f : 1.f / sum;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + (int64_t)row * D + 8 * j + c) =
          __floats2bfloat162_rn(acc_o[4 * j + 2 * h] * inv, acc_o[4 * j + 2 * h + 1] * inv);
    if (c == 0) lse[row] = dead ? FLT_MAX : (m[h] + log2f(sum)) * LN2;
  }
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s_q,
                int s_k, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err;
  if ((err = make_map<D>(&tm_q, q, bh, s_q)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_k, k, bh, s_k)) != cudaSuccess) return err;
  if ((err = make_map<D>(&tm_v, v, bh, s_k)) != cudaSuccess) return err;
  const size_t smem = sizeof(FwdSmem<D>) + 1024;
  auto kernel = flash_fwd_sm90_kernel<D>;
  static const cudaError_t set = set_smem(kernel, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((s_q + FWD_BQ - 1) / FWD_BQ, bh);
  kernel<<<grid, FWD_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, (bf16*)o, (float*)lse, s_q, s_k,
                                              causal, scale);
  return cudaGetLastError();
}

template <int D>
int fwd_ctas_per_sm() {
  int n = 0;
  const size_t smem = sizeof(FwdSmem<D>) + 1024;
  if (set_smem(flash_fwd_sm90_kernel<D>, smem) != cudaSuccess) return -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_fwd_sm90_kernel<D>, FWD_THREADS, smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// CTAs of the forward kernel that fit on one SM (-1 on error).
int flash_fwd_sm90_ctas_per_sm(int head_dim) {
  return head_dim == 32 ? fwd_ctas_per_sm<32>() : head_dim == 64 ? fwd_ctas_per_sm<64>() : -1;
}

// bf16 forward, head_dim 32 or 64 (else cudaErrorInvalidValue).
cudaError_t flash_fwd_sm90(int head_dim, const void* q, const void* k, const void* v, void* o,
                           void* lse, int bh, int s_q, int s_k, int causal, float scale,
                           cudaStream_t stream) {
  if (head_dim == 32) return fwd<32>(q, k, v, o, lse, bh, s_q, s_k, causal, scale, stream);
  if (head_dim == 64) return fwd<64>(q, k, v, o, lse, bh, s_q, s_k, causal, scale, stream);
  return cudaErrorInvalidValue;
}
