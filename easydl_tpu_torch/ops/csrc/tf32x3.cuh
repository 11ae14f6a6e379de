// Building blocks of the f32 flash-attention kernels (flash_fwd_f32_sm90.cu,
// flash_bwd_f32_sm90.cu): f32 tiles in shared memory filled by cp.async, and
// f32-accurate products on the tensor cores in 3xTF32 with mma.sync.m16n8k8.
//
// 3xTF32. Each operand x is split in registers into big = x rounded to
// TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32 does; an
// integer add and mask) and small = x − big, which is exact in f32; the
// tensor core ignores the low 13 bits of small (truncation, an error of at
// most 2^-21 |x|). Then a·b = a_small·b_big + a_big·b_small + a_big·b_big
// in f32 accumulators, dropping a_small·b_small (at most 2^-22 |a||b|).
// Shared memory holds each f32 tile once; the split costs three integer or
// f32 instructions a value beside three mma.sync.m16n8k8 per 16x8x8 step.
//
// The tensor core adds its products to the accumulator and truncates the
// sum (toward zero) to f32. Summed over many steps into one accumulator,
// that error builds up as a bias of up to one f32 ulp of the running sum a
// step. With RN = true a product sums each step's three mma.sync into
// fresh registers and adds them to its accumulator on the CUDA cores,
// rounded to nearest: one FADD a value a step.
//
// A CTA is 4 warps; each owns 16 of a tile's 64 rows. A tile is 64 rows of
// D floats (D = 32 or 64), padded to D + 4 so that every fragment load below
// is free of bank conflicts.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;  // rows of every tile: a CTA's q or key rows, a streamed tile
constexpr int WARPS = 4;  // each owns 16 of the CTA's rows
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// f32 tiles in shared memory: [ROWS][D + 4]. The pad of 4 floats makes
// row r start at bank 4r (mod 32), so a warp reading rows g (+8) at
// columns t (+4), or rows 2t (+1) at columns g, touches 32 distinct banks.
template <int D> __host__ __device__ constexpr int ld() { return D + 4; }
template <int D> __host__ __device__ constexpr int tile_floats() { return ROWS * ld<D>(); }

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a [rows, D] f32 matrix into a tile, by the
// whole CTA; rows past the end are filled with zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int rows) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int n = 0; n < ROWS * CHUNKS / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS, row = row0 + r;
    const bool valid = row < rows;
    cp_async16(dst + r * ld<D>() + 4 * c, src + (int64_t)(valid ? row : 0) * D + 4 * c, valid);
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------
//
// Fragments of thread lane = 4g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).

// big = x rounded to TF32 (nearest, ties away from zero), small = x − big.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

struct Frag {  // an A fragment, split
  uint32_t big[4], small[4];
};

__device__ __forceinline__ void split_a(Frag& f, float a0, float a1, float a2, float a3) {
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b for one 16x8x8 step in 3xTF32; b0, b1 are this thread's B values.
// RN: the step summed apart and added to d in f32, rounded to nearest.
template <bool RN = false>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0, float b1) {
  if constexpr (RN) {
    float step[4] = {0.f, 0.f, 0.f, 0.f};
    mma3<false>(step, a, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += step[e];
  } else {
    uint32_t b0_big, b0_small, b1_big, b1_small;
    split(b0, b0_big, b0_small);
    split(b1, b1_big, b1_small);
    mma_tf32(d, a.small, b0_big, b1_big);
    mma_tf32(d, a.big, b0_small, b1_small);
    mma_tf32(d, a.big, b0_big, b1_big);
  }
}

// The A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 7 of a tile.
template <int D>
__device__ __forceinline__ void tile_a(Frag& f, const float* tile, int r0, int c0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = tile + (r0 + g) * ld<D>() + c0 + t;
  split_a(f, p[0], p[8 * ld<D>()], p[4], p[8 * ld<D>() + 4]);
}

// acc[j] += X[r0 .. +16, :] · Y[8j .. 8j + 8, :]ᵀ for j < 8: a 16x64 product
// over D, both operands rows of tiles (S = Q·Kᵀ and its kind).
template <int D, bool RN = false>
__device__ __forceinline__ void product_abt(float (&acc)[8][4], const float* x, int r0,
                                            const float* y) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    Frag a;
    tile_a<D>(a, x, r0, 8 * kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* b = y + (8 * j + g) * ld<D>() + 8 * kk + t;
      mma3<RN>(acc[j], a, b[0], b[4]);
    }
  }
}

// acc[n] += P · Y[:, 8n .. 8n + 8] for n < D/8, with P (16 x 64) in the
// accumulator registers of a product_abt: k8 step j reads P's columns
// 8j + 2t, 8j + 2t + 1 as its logical k = t, t + 4, and Y's rows likewise.
template <int D, bool RN = false>
__device__ __forceinline__ void product_ab(float (&acc)[D / 8][4], const float (&p)[8][4],
                                           const float* y) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    Frag a;
    split_a(a, p[j][0], p[j][2], p[j][1], p[j][3]);
    const float* b = y + (8 * j + 2 * t) * ld<D>() + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) mma3<RN>(acc[n], a, b[8 * n], b[ld<D>() + 8 * n]);
  }
}

// Number of key tiles that rows [q0, q0 + 64) can see.
__device__ __forceinline__ int live_key_tiles(int q0, int s_q, int s_k, int causal) {
  const int n_k = (s_k + ROWS - 1) / ROWS;
  if (!causal) return n_k;
  const int last_row = min(q0 + ROWS, s_q);  // exclusive
  return max(0, min((last_row + (s_k - s_q) + ROWS - 1) / ROWS, n_k));
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename K>
int ctas_per_sm(K kernel, size_t smem) {
  int n = 0;
  if (set_smem(kernel, smem) != cudaSuccess) return -1;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem) == cudaSuccess
             ? n
             : -1;
}

}  // namespace
