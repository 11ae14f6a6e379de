// Flash attention forward for Hopper tensor cores in f32 (head_dim 32, 64):
// O = softmax(q·kᵀ·scale)·v and the row logsumexp lse, online over key
// tiles, every product in 3xTF32.
//
// Replaces, on the f32 path (BERT's model), _fwd_kernel of
// easydl_tpu/ops/flash_attention.py (the pallas_call in _fwd). Same
// interface and results as the bf16 kernel of flash_fwd_sm90.cu: q and O f32
// [bh, s_q, d], k and v f32 [bh, s_k, d], contiguous and 16-byte aligned;
// lse (natural log) f32 [bh, s_q]; the scale is folded in; the causal mask
// is bottom-right aligned (row r sees column c iff r + s_k - s_q >= c); rows
// that see no key get O = 0 and lse = +FLT_MAX, so the backward's
// exp(s − lse) is exactly 0 for them; ragged tails of s_q and s_k are masked
// here. No atomics: each output element is summed by one thread in a fixed
// order, so two calls on the same inputs agree bit for bit.
//
// What bounds it. At BERT-base's shape [bh 96, s 512, d 64] it does
// 6.44 GFLOP (S = Q·Kᵀ, O = P·V) against 50 MB (0.015 ms at 3.35 TB/s), so
// it is bound by operations: 0.096 ms on the CUDA cores (67 TFLOP/s f32),
// 0.039 ms in 3xTF32 on the tensor cores (495/3 TFLOP/s).
//
// 3xTF32 (tf32x3.cuh): each operand split in registers into a TF32 big
// part and the f32 rest, three mma.sync.m16n8k8 products per 16x8x8 step,
// f32-level accuracy. mma.sync rather than wgmma: wgmma takes TF32 operands
// only K-major from shared memory, so O += P·V would need a transposed copy
// of V, and 3xTF32 a big and a small copy of it. Both products add each
// 16x8x8 step to their accumulator in f32, rounded to nearest (RN in
// tf32x3.cuh). On an H100 that costs 16% of the time (0.150 against 0.129
// ms at BERT-base's shape), and O sits 5.6e-7 from the plain version in
// relative L2 instead of 4.0e-6: summed over 512 keys in one tensor-core
// accumulator, the truncation's bias reached the key projections'
// gradients of BERT-base through Δ = rowsum(dO∘O), 4.8e-3 from the
// reference attention's instead of 3.3e-4.
//
// Design, the backward kernels' (flash_bwd_f32_sm90.cu) carried over. A CTA
// of 4 warps owns 64 q rows (each warp 16). Its Q tile stays in shared
// memory; K and V stream through a double buffer, all as f32 rows padded to
// D + 4 floats and filled by cp.async 16-byte copies (zeros past the end)
// that run while the previous tile's products do. Two CTAs share an SM
// (87 KB of shared memory and 255 registers a thread at D = 64; Q kept as
// split fragments in registers instead was 3% faster at 234 registers
// before the per-step sums, and 128 q rows on 8 warps no faster). Per key
// tile a warp computes S = Q·Kᵀ into a 16x64 accumulator and runs the
// online softmax on it in registers: S·scale·log2e (log2 domain), the mask
// only on tiles that cross the key tail or the causal diagonal, the row max
// over the quad (__shfl_xor 1 and 2), P = exp2(S − max), the O accumulator
// rescaled by exp2(old max − new max). P then feeds O += P·V as the A operand without
// leaving registers: the m16n8 accumulator holds columns 2t and 2t + 1
// where the k8 A fragment wants t and t + 4, so the reduction index of
// each k8 step is permuted (logical t -> 2t, t + 4 -> 2t + 1) and V's rows
// are read likewise. Each thread sums its own part of the row's P, and the
// quad adds the parts once, at the end. The epilogue is f32: O = acc / l,
// lse = (max + log2 l)·ln 2.
//
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr size_t fwd_smem() {  // Q; K and V twice
  return sizeof(float) * 5 * tile_floats<D>();
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_f32_sm90_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int s_q, int s_k, int causal, float scale) {
  constexpr int TF = tile_floats<D>();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + TF;      // [2][TF]
  float* v_s = k_s + 2 * TF;  // [2][TF]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest causal tiles first
  const int r0 = threadIdx.x / 32 * 16;                // this warp's rows of the tile
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int offset = s_k - s_q;
  q += (int64_t)bh * s_q * D;
  o += (int64_t)bh * s_q * D;
  k += (int64_t)bh * s_k * D;
  v += (int64_t)bh * s_k * D;
  lse += (int64_t)bh * s_q;

  const int n_k = live_key_tiles(q0, s_q, s_k, causal);
  load_tile<D>(q_s, q, q0, s_q);
  if (n_k > 0) {
    load_tile<D>(k_s, k, 0, s_k);
    load_tile<D>(v_s, v, 0, s_k);
  }
  cp_async_commit();

  // rows g and g + 8 of this warp's 16: the running max (log2 units; -inf
  // while the row has seen no key) and this thread's part of the sum
  const float scale_log2 = scale * LOG2E;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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
    cp_async_wait<1>();  // this tile (and Q) landed for this thread's copies
    __syncthreads();     // ... and for everyone's
    const float* ks = k_s + stage * TF;
    const float* vs = v_s + stage * TF;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    product_abt<D, true>(s, q_s, r0, ks);

    // the tile crosses the key tail (K rows past s_k are zeros) or the
    // causal diagonal
    const int k0 = i * ROWS;
    const bool masked = k0 + ROWS > s_k || (causal && k0 + ROWS - 1 > q0 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int row = q0 + r0 + g + 8 * h, col = k0 + 8 * j + 2 * t + e % 2;
          if (col >= s_k || (causal && row + offset < col)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float base[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // a row that has seen no key yet subtracts 0, so that its P and its
      // correction are exp2(-inf) = 0 rather than NaN
      base[h] = mx[h] == -INFINITY ? 0.f : mx[h];
      corr[h] = exp2f(m[h] - base[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - base[e / 2]);  // P
        l[e / 2] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];
    product_ab<D, true>(acc, s, vs);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + r0 + g + 8 * h;
    if (row >= s_q) continue;
    const bool dead = m[h] == -INFINITY;  // saw no key: acc and l are 0
    const float l_h = dead ? 1.f : l[h];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(o + (int64_t)row * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] / l_h, acc[n][2 * h + 1] / l_h);
    if (t == 0) lse[row] = dead ? FLT_MAX : (m[h] + log2f(l[h])) * LN2;
  }
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                int s_q, int s_k, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_sm90_kernel<D>;
  static const cudaError_t set = set_smem(kernel, fwd_smem<D>());
  if (set != cudaSuccess) return set;
  const dim3 grid((s_q + ROWS - 1) / ROWS, bh);
  kernel<<<grid, THREADS, fwd_smem<D>(), stream>>>((const float*)q, (const float*)k,
                                                   (const float*)v, (float*)o, (float*)lse, s_q,
                                                   s_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// f32 O and lse, head_dim 32 or 64 (else cudaErrorInvalidValue).
cudaError_t flash_fwd_f32_sm90(int head_dim, const void* q, const void* k, const void* v, void* o,
                               void* lse, int bh, int s_q, int s_k, int causal, float scale,
                               cudaStream_t stream) {
  if (head_dim == 32) return fwd<32>(q, k, v, o, lse, bh, s_q, s_k, causal, scale, stream);
  if (head_dim == 64) return fwd<64>(q, k, v, o, lse, bh, s_q, s_k, causal, scale, stream);
  return cudaErrorInvalidValue;
}

// CTAs of the f32 forward kernel that fit on one SM (-1 on error).
int flash_fwd_f32_sm90_ctas_per_sm(int head_dim) {
  return head_dim == 32   ? ctas_per_sm(flash_fwd_f32_sm90_kernel<32>, fwd_smem<32>())
         : head_dim == 64 ? ctas_per_sm(flash_fwd_f32_sm90_kernel<64>, fwd_smem<64>())
                          : -1;
}
