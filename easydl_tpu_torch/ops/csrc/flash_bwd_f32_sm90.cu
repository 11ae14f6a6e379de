// Flash attention backward for Hopper tensor cores in f32 (head_dim 32, 64):
// dq with Δ = rowsum(dO∘O), and dk/dv, every product in 3xTF32.
//
// Replaces, on the f32 path (BERT's model), _bwd_dq_kernel and
// _bwd_dkv_kernel of easydl_tpu/ops/flash_attention.py (the two pallas_calls
// in _bwd) and the einsum for Δ in front of them. Same interface and
// results as the bf16 kernels of flash_bwd_dq_sm90.cu and
// flash_bwd_dkv_sm90.cu: q, k, v, O and dO f32 [bh, s, d], contiguous and
// 16-byte aligned; lse (natural log) and Δ f32 [bh, s_q]; the dq kernel
// computes Δ in f32 on the CUDA cores and writes it for dk/dv; rows with
// lse = +FLT_MAX (they saw no key) contribute nothing and get dq = 0
// exactly; the causal mask is bottom-right aligned; ragged tails of s_q and
// s_k are masked here. No atomics: each output element is summed by one
// thread in a fixed order, so two calls on the same inputs agree bit for bit.
//
// What bounds it. At BERT-base's shape [bh 96, s 512, d 64] dq does
// 9.67 GFLOP (S, dP, dS·K) and dk/dv 12.9 (Sᵀ, dPᵀ, Pᵀ·dO, dSᵀ·Q) against
// 76 MB each (0.023 ms at 3.35 TB/s), so both are bound by operations. On
// the CUDA cores (67 TFLOP/s f32) the least time is 0.144 and 0.192 ms.
// The tensor cores take TF32 (an f32 with 10 explicit mantissa bits) at
// 495 TFLOP/s; three TF32 products per f32 product keep f32-level
// accuracy, so f32-accurate work can run at 495/3 = 165 TFLOP/s: 0.059
// and 0.078 ms.
//
// 3xTF32 (tf32x3.cuh): each operand split in registers into a TF32 big
// part and the f32 rest, three mma.sync.m16n8k8 products per 16x8x8 step,
// f32-level accuracy.
//
// Design. mma.sync rather than wgmma: wgmma takes TF32 operands only
// K-major from shared memory, so dQ += dS·K, dK += dSᵀ·Q and dV += Pᵀ·dO
// would need transposed copies, and 3xTF32 a big and a small copy of each:
// four times the staged bytes. A CTA of 4 warps owns 64 rows (each warp
// 16): q rows for dq, key rows for dk/dv. Its resident tiles (Q and dO, or
// K and V) and a double buffer of the streamed tiles (K and V, or Q and dO)
// sit in shared memory as f32 rows padded to D + 4 floats, filled by
// cp.async 16-byte copies (zeros past the end) that run while the previous
// tile's products do. With that padding every fragment load below is free
// of bank conflicts. Two CTAs share an SM (~104 KB of shared memory each).
// Per streamed tile a warp computes S = Q·Kᵀ and dP = dO·Vᵀ (dq) or Sᵀ =
// K·Qᵀ and dPᵀ = V·dOᵀ (dk/dv) into 16x64 accumulators, forms P and dS in
// those registers (f32, log2 domain; the mask only on tiles that cross the
// key tail or the causal diagonal), and feeds them as the A operand of the
// second product without leaving registers: the m16n8 accumulator holds
// columns 2t and 2t+1 where the k8 A fragment wants t and t + 4, so the
// reduction index of each k8 step is permuted (logical t -> 2t, t + 4 ->
// 2t + 1) and the B operand is read from the same rows. The accumulators of
// dq, or dk and dv, stay in registers to the end; the scale is applied in
// the f32 epilogue (to S before the exponential, to dq and dk at the end).
//
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cfloat>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// dq and Δ
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem() {  // Q, dO; K and V twice
  return sizeof(float) * 6 * tile_floats<D>();
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ o,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ delta, float* __restrict__ dq, int s_q,
                             int s_k, int causal, float scale) {
  constexpr int TF = tile_floats<D>();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + TF;
  float* k_s = do_s + TF;     // [2][TF]
  float* v_s = k_s + 2 * TF;  // [2][TF]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest causal tiles first
  const int r0 = threadIdx.x / 32 * 16;                // this warp's rows of the tile
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int offset = s_k - s_q;
  q += (int64_t)bh * s_q * D;
  o += (int64_t)bh * s_q * D;
  dout += (int64_t)bh * s_q * D;
  dq += (int64_t)bh * s_q * D;
  k += (int64_t)bh * s_k * D;
  v += (int64_t)bh * s_k * D;
  lse += (int64_t)bh * s_q;
  delta += (int64_t)bh * s_q;

  const int n_k = live_key_tiles(q0, s_q, s_k, causal);
  load_tile<D>(q_s, q, q0, s_q);
  load_tile<D>(do_s, dout, q0, s_q);
  if (n_k > 0) {
    load_tile<D>(k_s, k, 0, s_k);
    load_tile<D>(v_s, v, 0, s_k);
  }
  cp_async_commit();

  // While the tiles land: Δ = rowsum(dO∘O) of rows g and g + 8 from device
  // memory, each of the quad's threads over every fourth 16-byte chunk;
  // lse in log2 units, +inf for rows that saw no key, FLT_MAX past s_q:
  // P is exactly 0 in both.
  float dl[2], lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    float sum = 0.f;
    if (row < s_q) {
      const float4* d4 = reinterpret_cast<const float4*>(dout + (int64_t)row * D);
      const float4* o4 = reinterpret_cast<const float4*>(o + (int64_t)row * D);
#pragma unroll
      for (int c = t; c < D / 4; c += 4) {
        const float4 a = d4[c], b = o4[c];
        sum = fmaf(a.x, b.x, sum);
        sum = fmaf(a.y, b.y, sum);
        sum = fmaf(a.z, b.z, sum);
        sum = fmaf(a.w, b.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[h] = sum;
    if (t == 0 && row < s_q) delta[row] = sum;
    lse2[h] = row < s_q ? lse[row] * LOG2E : FLT_MAX;
  }

  const float scale_log2 = scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_k; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_k) {  // the next K/V tile, into the other stage
      load_tile<D>(k_s + (stage ^ 1) * TF, k, (i + 1) * ROWS, s_k);
      load_tile<D>(v_s + (stage ^ 1) * TF, v, (i + 1) * ROWS, s_k);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) landed for this thread's copies
    __syncthreads();     // ... and for everyone's
    const float* ks = k_s + stage * TF;
    const float* vs = v_s + stage * TF;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    product_abt<D>(s, q_s, r0, ks);
    product_abt<D>(dp, do_s, r0, vs);

    // the tile crosses the key tail (K rows past s_k are zeros, which would
    // give P = exp(−lse)) or the causal diagonal
    const int k0 = i * ROWS;
    const bool masked = k0 + ROWS > s_k || (causal && k0 + ROWS - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float p = exp2f(s[j][e] * scale_log2 - lse2[h]);
        if (masked) {
          const int row = q0 + r0 + g + 8 * h, col = k0 + 8 * j + 2 * t + e % 2;
          if (col >= s_k || (causal && row + offset < col)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[h]);  // dS
      }
    product_ab<D>(acc, s, ks);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= s_q) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dq + (int64_t)row * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem() {  // K, V; Q and dO twice; lse and Δ twice
  return sizeof(float) * (6 * tile_floats<D>() + 4 * ROWS);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, int s_q, int s_k,
                              int causal, float scale) {
  constexpr int TF = tile_floats<D>();
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + TF;
  float* q_s = v_s + TF;         // [2][TF]
  float* do_s = q_s + 2 * TF;    // [2][TF]
  float* lse_s = do_s + 2 * TF;  // [2][ROWS], log2 units
  float* dl_s = lse_s + 2 * ROWS;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * ROWS;
  const int r0 = threadIdx.x / 32 * 16;  // this warp's key rows of the tile
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int offset = s_k - s_q;
  q += (int64_t)bh * s_q * D;
  dout += (int64_t)bh * s_q * D;
  k += (int64_t)bh * s_k * D;
  v += (int64_t)bh * s_k * D;
  dk += (int64_t)bh * s_k * D;
  dv += (int64_t)bh * s_k * D;
  lse += (int64_t)bh * s_q;
  delta += (int64_t)bh * s_q;

  // lse (log2 units) and Δ of q-tile row `row` by thread threadIdx.x < 64;
  // +FLT_MAX and 0 past s_q, so P is exactly 0 there
  auto row_lse = [&](int row) { return row < s_q ? lse[row] * LOG2E : FLT_MAX; };
  auto row_dl = [&](int row) { return row < s_q ? delta[row] : 0.f; };

  const int n_q = (s_q + ROWS - 1) / ROWS;
  // q-tiles whose rows all satisfy row + offset < k0 never see these keys
  const int first_q = causal ? min(n_q, max(0, k0 - offset) / ROWS) : 0;
  load_tile<D>(k_s, k, k0, s_k);
  load_tile<D>(v_s, v, k0, s_k);
  if (first_q < n_q) {
    load_tile<D>(q_s, q, first_q * ROWS, s_q);
    load_tile<D>(do_s, dout, first_q * ROWS, s_q);
    if (threadIdx.x < ROWS) {
      lse_s[threadIdx.x] = row_lse(first_q * ROWS + threadIdx.x);
      dl_s[threadIdx.x] = row_dl(first_q * ROWS + threadIdx.x);
    }
  }
  cp_async_commit();

  const float scale_log2 = scale * LOG2E;
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int qb = first_q; qb < n_q; ++qb) {
    const int stage = (qb - first_q) & 1, q0 = qb * ROWS;
    const bool next = qb + 1 < n_q;
    float lse_next = 0.f, dl_next = 0.f;
    if (next) {  // the next q-tile, into the other stage; lse and Δ into registers
      load_tile<D>(q_s + (stage ^ 1) * TF, q, q0 + ROWS, s_q);
      load_tile<D>(do_s + (stage ^ 1) * TF, dout, q0 + ROWS, s_q);
      if (threadIdx.x < ROWS) {
        lse_next = row_lse(q0 + ROWS + threadIdx.x);
        dl_next = row_dl(q0 + ROWS + threadIdx.x);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qs = q_s + stage * TF;
    const float* dos = do_s + stage * TF;
    const float* ls = lse_s + stage * ROWS;
    const float* dls = dl_s + stage * ROWS;

    // Sᵀ and dPᵀ: rows are this warp's keys, columns the tile's queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    product_abt<D>(s, k_s, r0, qs);
    product_abt<D>(dp, v_s, r0, dos);

    // Keys past s_k need no mask: their dk and dv rows are never written.
    const bool masked = causal && q0 + offset < k0 + ROWS - 1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, c = e % 2;
        float p = exp2f(s[j][e] * scale_log2 - (c ? l2.y : l2.x));
        if (masked) {
          const int key = k0 + r0 + g + 8 * h, row = q0 + 8 * j + 2 * t + c;
          if (row + offset < key) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - (c ? d2.y : d2.x));  // dSᵀ
        s[j][e] = p;                                     // Pᵀ
      }
    }
    product_ab<D>(acc_dv, s, dos);
    product_ab<D>(acc_dk, dp, qs);
    if (next && threadIdx.x < ROWS) {  // the other stage was last read before the previous sync
      lse_s[(stage ^ 1) * ROWS + threadIdx.x] = lse_next;
      dl_s[(stage ^ 1) * ROWS + threadIdx.x] = dl_next;
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // Q is unscaled, so dk takes the scale here.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + r0 + g + 8 * h;
    if (row >= s_k) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int64_t at = (int64_t)row * D + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(acc_dk[n][2 * h] * scale, acc_dk[n][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + at) = make_float2(acc_dv[n][2 * h], acc_dv[n][2 * h + 1]);
    }
  }
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, int bh, int s_q, int s_k, int causal,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_f32_sm90_kernel<D>;
  static const cudaError_t set = set_smem(kernel, dq_smem<D>());
  if (set != cudaSuccess) return set;
  const dim3 grid((s_q + ROWS - 1) / ROWS, bh);
  kernel<<<grid, THREADS, dq_smem<D>(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout,
      (const float*)lse, (float*)delta, (float*)dq, s_q, s_k, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int s_q,
                    int s_k, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_f32_sm90_kernel<D>;
  static const cudaError_t set = set_smem(kernel, dkv_smem<D>());
  if (set != cudaSuccess) return set;
  const dim3 grid((s_k + ROWS - 1) / ROWS, bh);
  kernel<<<grid, THREADS, dkv_smem<D>(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dk, (float*)dv, s_q, s_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// f32 dq and Δ, head_dim 32 or 64 (else cudaErrorInvalidValue).
cudaError_t flash_bwd_dq_f32_sm90(int head_dim, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const void* lse, void* delta,
                                  void* dq, int bh, int s_q, int s_k, int causal, float scale,
                                  cudaStream_t stream) {
  if (head_dim == 32)
    return bwd_dq<32>(q, k, v, o, dout, lse, delta, dq, bh, s_q, s_k, causal, scale, stream);
  if (head_dim == 64)
    return bwd_dq<64>(q, k, v, o, dout, lse, delta, dq, bh, s_q, s_k, causal, scale, stream);
  return cudaErrorInvalidValue;
}

// f32 dk and dv, head_dim 32 or 64 (else cudaErrorInvalidValue).
cudaError_t flash_bwd_dkv_f32_sm90(int head_dim, const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, int bh, int s_q, int s_k, int causal,
                                   float scale, cudaStream_t stream) {
  if (head_dim == 32)
    return bwd_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_k, causal, scale, stream);
  if (head_dim == 64)
    return bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_k, causal, scale, stream);
  return cudaErrorInvalidValue;
}

// CTAs of the f32 dq or dk/dv kernel that fit on one SM (-1 on error).
int flash_bwd_dq_f32_sm90_ctas_per_sm(int head_dim) {
  return head_dim == 32   ? ctas_per_sm(flash_bwd_dq_f32_sm90_kernel<32>, dq_smem<32>())
         : head_dim == 64 ? ctas_per_sm(flash_bwd_dq_f32_sm90_kernel<64>, dq_smem<64>())
                          : -1;
}

int flash_bwd_dkv_f32_sm90_ctas_per_sm(int head_dim) {
  return head_dim == 32   ? ctas_per_sm(flash_bwd_dkv_f32_sm90_kernel<32>, dkv_smem<32>())
         : head_dim == 64 ? ctas_per_sm(flash_bwd_dkv_f32_sm90_kernel<64>, dkv_smem<64>())
                          : -1;
}
