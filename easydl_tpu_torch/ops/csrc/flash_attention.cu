// Flash attention for Hopper (sm_90a): the forward, dq and dk/dv kernels.
//
// Replaces the Pallas TPU kernels of easydl_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel      (the pallas_call in _fwd)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (the first pallas_call in _bwd)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (the second pallas_call in _bwd)
//
// The bf16 kernels, the training path, are the tensor-core kernels of
// flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu and flash_bwd_dkv_sm90.cu, reached
// from the same C entry points below. This file holds the f32 path's
// kernels, exact in f32, not a fallback.
//
// Layout: q, O and dO [bh, s_q, d], k and v [bh, s_k, d], all contiguous;
// lse and delta [bh, s_q] in f32. The dq kernel computes delta = rowsum(dO∘O)
// from its own tiles and writes it for dk/dv. The softmax scale is folded
// into q. Causal masking is bottom-right aligned: row r sees column c iff
// r + (s_k - s_q) >= c.
// Rows that see no key write O = 0 and lse = +FLT_MAX, so the backward's
// exp(s - lse) is exactly 0 for them. Ragged tails (s not a multiple of the
// 64-row tile) are masked here, so no length needs a fallback.
//
// What bounds it. The tensor cores take no exact f32 operands (TF32 would
// round), so these kernels are the simple design: one block of 256 threads
// per (bh, 64-row tile), K/V (or Q/dO) tiles staged in shared memory as f32,
// every product an f32 FMA on the CUDA cores from shared memory. The score
// tile never leaves shared memory, so traffic stays O(s * d) as on the TPU;
// the time is bound by shared-memory loads feeding the FMAs.
//
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int THREADS = 256;   // 16 x 16; a thread owns rows ty+16i, cols tx+16j
constexpr int LDS = BK + 1;    // row stride of a score tile (padded against bank conflicts)
constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min, the TPU kernel's sentinel

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// Rows [row0, row0 + 64) of a [rows, D] matrix into shared memory as f32,
// times mul, with row stride D + 1; rows past the end are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows, float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D, g = row0 + r;
    dst[r * (D + 1) + c] = g < rows ? to_f(src[(int64_t)g * D + c]) * mul : 0.f;
  }
}

// Per-row f32 values [row0, row0 + 64) into shared memory; pad past the end.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows, float pad) {
  if (threadIdx.x < 64) {
    const int g = row0 + threadIdx.x;
    dst[threadIdx.x] = g < rows ? src[g] : pad;
  }
}

// s[i][j] = sum_d a[ty + 16i][d] * b[tx + 16j][d]  (a, b: 64 x D, stride D + 1)
template <int D>
__device__ __forceinline__ void tile_abt(float (&s)[4][4], const float* a, const float* b) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_k p[ty + 16i][k] * x[k][tx + 16j]   (p: 64 x 64, x: 64 x D)
template <int D>
__device__ __forceinline__ void tile_ab(float (&acc)[4][D / 16], const float* p, const float* x) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * LDS + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float xv = x[k * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_r p[r][ty + 16i] * x[r][tx + 16j]   (p transposed)
template <int D>
__device__ __forceinline__ void tile_atb(float (&acc)[4][D / 16], const float* p, const float* x) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[r * LDS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float xv = x[r * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
    }
  }
}

__device__ __forceinline__ bool visible(int row, int col, int s_q, int s_k, int offset, int causal) {
  return row < s_q && col < s_k && (!causal || row + offset >= col);
}

// Number of key tiles that rows [q0, q0 + 64) can see.
__device__ __forceinline__ int live_key_tiles(int q0, int s_q, int s_k, int causal) {
  const int n_k = (s_k + BK - 1) / BK;
  if (!causal) return n_k;
  const int last_row = min(q0 + BQ, s_q);  // exclusive
  const int n = (last_row + (s_k - s_q) + BK - 1) / BK;
  return max(0, min(n, n_k));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int s_q, int s_k, int causal,
                 float scale) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][LD], scaled
  float* k_s = q_s + BQ * LD;    // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][LD]
  float* s_s = v_s + BK * LD;    // [BQ][LDS]
  float* m_s = s_s + BQ * LDS;   // running max
  float* l_s = m_s + BQ;         // running normaliser
  float* c_s = l_s + BQ;         // this tile's correction exp(m_old - m_new)

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = s_k - s_q;
  q += (int64_t)bh * s_q * D;
  o += (int64_t)bh * s_q * D;
  k += (int64_t)bh * s_k * D;
  v += (int64_t)bh * s_k * D;
  lse += (int64_t)bh * s_q;

  load_tile<T, D>(q_s, q, q0, s_q, scale);
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_k = live_key_tiles(q0, s_q, s_k, causal);
  for (int kb = 0; kb < n_k; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, k, k0, s_k, 1.f);
    load_tile<T, D>(v_s, v, k0, s_k, 1.f);
    __syncthreads();

    float s[4][4];
    tile_abt<D>(s, q_s, k_s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        s_s[r * LDS + c] = visible(q0 + r, k0 + c, s_q, s_k, offset, causal) ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    {  // online softmax: four threads per row, each over 16 columns
      const int r = threadIdx.x / 4, part = threadIdx.x % 4;
      float* row = s_s + r * LDS + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    tile_ab<D>(acc, s_s, v_s);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= s_q) continue;
    const float m = m_s[r];
    const float l = fmaxf(l_s[r], 1e-30f);
    // A row that saw no visible key still has m at the sentinel: zero output.
    const bool dead = m <= NEG_INF * 0.5f;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[(int64_t)row * D + tx + 16 * j] = from_f<T>(dead ? 0.f : acc[i][j] / l);
    if (tx == 0) lse[row] = dead ? FLT_MAX : m + logf(l);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int s_q, int s_k, int causal, float scale) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][LD], scaled
  float* do_s = q_s + BQ * LD;    // [BQ][LD]
  float* k_s = do_s + BQ * LD;    // [BK][LD]
  float* v_s = k_s + BK * LD;     // [BK][LD]
  float* ds_s = v_s + BK * LD;    // [BQ][LDS]
  float* lse_s = ds_s + BQ * LDS;
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = s_k - s_q;
  q += (int64_t)bh * s_q * D;
  o += (int64_t)bh * s_q * D;
  dout += (int64_t)bh * s_q * D;
  dq += (int64_t)bh * s_q * D;
  k += (int64_t)bh * s_k * D;
  v += (int64_t)bh * s_k * D;
  lse += (int64_t)bh * s_q;
  delta += (int64_t)bh * s_q;

  load_tile<T, D>(q_s, q, q0, s_q, scale);
  load_tile<T, D>(do_s, dout, q0, s_q, 1.f);
  load_tile<T, D>(k_s, o, q0, s_q, 1.f);  // O, for Δ only: the loop reloads k_s
  load_rows(lse_s, lse, q0, s_q, FLT_MAX);
  __syncthreads();
  {  // Δ = rowsum(dO∘O): four threads per row, each over D/4 columns; 0 past s_q
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float sum = 0.f;
#pragma unroll
    for (int c = part * (D / 4); c < (part + 1) * (D / 4); ++c)
      sum = fmaf(do_s[r * LD + c], k_s[r * LD + c], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      dl_s[r] = sum;
      if (q0 + r < s_q) delta[q0 + r] = sum;
    }
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_k = live_key_tiles(q0, s_q, s_k, causal);
  for (int kb = 0; kb < n_k; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    load_tile<T, D>(k_s, k, k0, s_k, 1.f);
    load_tile<T, D>(v_s, v, k0, s_k, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(s, q_s, k_s);
    tile_abt<D>(dp, do_s, v_s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, s_q, s_k, offset, causal) ? expf(s[i][j] - l) : 0.f;
        ds_s[r * LDS + c] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    tile_ab<D>(acc, ds_s, k_s);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_q) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[(int64_t)row * D + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int s_q, int s_k, int causal, float scale) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;              // [BK][LD]
  float* v_s = k_s + BK * LD;     // [BK][LD]
  float* q_s = v_s + BK * LD;     // [BQ][LD], scaled
  float* do_s = q_s + BQ * LD;    // [BQ][LD]
  float* p_s = do_s + BQ * LD;    // [BQ][LDS]
  float* ds_s = p_s + BQ * LDS;   // [BQ][LDS]
  float* lse_s = ds_s + BQ * LDS;
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = s_k - s_q;
  q += (int64_t)bh * s_q * D;
  dout += (int64_t)bh * s_q * D;
  k += (int64_t)bh * s_k * D;
  v += (int64_t)bh * s_k * D;
  dk += (int64_t)bh * s_k * D;
  dv += (int64_t)bh * s_k * D;
  lse += (int64_t)bh * s_q;
  delta += (int64_t)bh * s_q;

  load_tile<T, D>(k_s, k, k0, s_k, 1.f);
  load_tile<T, D>(v_s, v, k0, s_k, 1.f);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (s_q + BQ - 1) / BQ;
  // Query tiles whose rows all satisfy row + offset < k0 never see this tile.
  const int first_q = causal ? min(n_q, max(0, k0 - offset) / BQ) : 0;
  for (int qb = first_q; qb < n_q; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();
    load_tile<T, D>(q_s, q, q0, s_q, scale);
    load_tile<T, D>(do_s, dout, q0, s_q, 1.f);
    load_rows(lse_s, lse, q0, s_q, FLT_MAX);
    load_rows(dl_s, delta, q0, s_q, 0.f);
    __syncthreads();

    float s[4][4], dp[4][4];  // rows: queries ty+16i; cols: keys tx+16j
    tile_abt<D>(s, q_s, k_s);
    tile_abt<D>(dp, do_s, v_s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = lse_s[r], dl = dl_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, s_q, s_k, offset, causal) ? expf(s[i][j] - l) : 0.f;
        p_s[r * LDS + c] = p;
        ds_s[r * LDS + c] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    tile_atb<D>(dv_acc, p_s, do_s);
    // q_s already carries the scale, so dk needs none beyond it.
    tile_atb<D>(dk_acc, ds_s, q_s);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= s_k) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[(int64_t)row * D + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dv[(int64_t)row * D + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <int D> constexpr size_t fwd_smem() { return sizeof(float) * (3 * 64 * (D + 1) + 64 * LDS + 3 * 64); }
template <int D> constexpr size_t dq_smem() { return sizeof(float) * (4 * 64 * (D + 1) + 64 * LDS + 2 * 64); }
template <int D> constexpr size_t dkv_smem() { return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * LDS + 2 * 64); }

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s_q,
                int s_k, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = prepare(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((s_q + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, fwd_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, s_q, s_k, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, int bh, int s_q, int s_k, int causal,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((s_q + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, dq_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, (const float*)lse,
      (float*)delta, (T*)dq, s_q, s_k, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dk, void* dv, int bh, int s_q, int s_k, int causal,
                    float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = prepare(kernel, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((s_k + BK - 1) / BK, bh);
  kernel<<<grid, THREADS, dkv_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, s_q, s_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The bf16 tensor-core kernels (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu,
// flash_bwd_dkv_sm90.cu).
cudaError_t flash_fwd_sm90(int head_dim, const void* q, const void* k, const void* v, void* o,
                           void* lse, int bh, int s_q, int s_k, int causal, float scale,
                           cudaStream_t stream);
cudaError_t flash_bwd_dkv_sm90(int head_dim, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta, void* dk,
                               void* dv, int bh, int s_q, int s_k, int causal, float scale,
                               cudaStream_t stream);
cudaError_t flash_bwd_dq_sm90(int head_dim, const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const void* lse, void* delta,
                              void* dq, int bh, int s_q, int s_k, int causal, float scale,
                              cudaStream_t stream);
int flash_fwd_sm90_ctas_per_sm(int head_dim);
int flash_bwd_dkv_sm90_ctas_per_sm(int head_dim);
int flash_bwd_dq_sm90_ctas_per_sm(int head_dim);

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Anything else is
// refused with cudaErrorInvalidValue; the Python wrapper checks first.
#define EASYDL_DISPATCH_F32(FN, ...)                                      \
  if (dtype == 0 && head_dim == 32) return (int)FN<float, 32>(__VA_ARGS__); \
  if (dtype == 0 && head_dim == 64) return (int)FN<float, 64>(__VA_ARGS__);

extern "C" {

const char* easydl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// CTAs per SM of a bf16 tensor-core kernel (0 = forward, 1 = dk/dv, 2 = dq),
// -1 on error.
int easydl_flash_sm90_ctas_per_sm(int kernel, int head_dim) {
  return kernel == 0   ? flash_fwd_sm90_ctas_per_sm(head_dim)
         : kernel == 1 ? flash_bwd_dkv_sm90_ctas_per_sm(head_dim)
         : kernel == 2 ? flash_bwd_dq_sm90_ctas_per_sm(head_dim)
                       : -1;
}

int easydl_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                     void* o, void* lse, int bh, int s_q, int s_k, int causal, float scale,
                     void* stream) {
  EASYDL_DISPATCH_F32(fwd, q, k, v, o, lse, bh, s_q, s_k, causal, scale, (cudaStream_t)stream)
  if (dtype == 1)
    return (int)flash_fwd_sm90(head_dim, q, k, v, o, lse, bh, s_q, s_k, causal, scale,
                               (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// dq and delta = rowsum(dO∘O) (written for flash_bwd_dkv).
int easydl_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse, void* delta, void* dq,
                        int bh, int s_q, int s_k, int causal, float scale, void* stream) {
  EASYDL_DISPATCH_F32(bwd_dq, q, k, v, o, dout, lse, delta, dq, bh, s_q, s_k, causal, scale,
                      (cudaStream_t)stream)
  if (dtype == 1)
    return (int)flash_bwd_dq_sm90(head_dim, q, k, v, o, dout, lse, delta, dq, bh, s_q, s_k,
                                  causal, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

int easydl_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                         int bh, int s_q, int s_k, int causal, float scale, void* stream) {
  EASYDL_DISPATCH_F32(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_k, causal, scale,
                      (cudaStream_t)stream)
  if (dtype == 1)
    return (int)flash_bwd_dkv_sm90(head_dim, q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_k,
                                   causal, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
