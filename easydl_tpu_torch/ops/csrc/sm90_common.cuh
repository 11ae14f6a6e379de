// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels:
// mbarriers, TMA loads through 3-D tensor maps, wgmma shared-memory
// descriptors, and the three wgmma shapes the kernels issue.
//
// Tile layout. Every bf16 tile is [64 rows, D] with D = 64 (128-byte rows)
// or D = 32 (64-byte rows), written by TMA with the swizzle of its row size
// (128 B or 64 B), at a 1024-byte aligned address. wgmma reads it either
// K-major (the row is the reduction dimension: Q and K in S = Q·Kᵀ) or
// MN-major (the row is the output dimension: V in O += P·V). The descriptor
// swizzle must be the TMA swizzle, or the products come out wrong without
// any error.
//
// Accumulator layout of m64nNk16 (f32), thread t of the warpgroup, warp
// w = t / 32, lane l = t % 32: element 4j + 2h + e sits at row
// 16w + l/4 + 8h, column 8j + 2(l%4) + e. So a row lives in the four
// threads of a quad (reduce with __shfl_xor 1 and 2), and the elements
// 8c .. 8c+7, packed in pairs to bf16x2, are the register-A fragment of the
// k16 chunk c of the next product.

#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min, the TPU kernel's sentinel
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int TILE = 64;  // rows of every TMA box and of every warpgroup's tile

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the process already uses,
// so the library links against the CUDA runtime only.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return libcuda ? reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"))
                   : nullptr;
  }();
  return fn;
}

// A contiguous bf16 [bh, rows, D] tensor as a TMA map of [1, 64, D] boxes.
// The map is 3-D, so a box that runs past `rows` is filled with zeros
// within its own head rather than read from the next one.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* base, int bh, int rows) {
  static_assert(D == 32 || D == 64, "head_dim 32 or 64");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {D, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {D * sizeof(bf16), (cuuint64_t)rows * D * sizeof(bf16)};
  const cuuint32_t box[3] = {D, TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// device: shared memory, barriers, TMA
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T& aligned_smem(uint8_t* raw) {
  // the dynamic allocation carries 1024 spare bytes for this
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023);
  return *reinterpret_cast<T*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival, and `bytes` more of TMA traffic before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of the given parity has completed. A wait that
// never ends (a broken pipeline) traps, so the launch fails with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Box [1, 64, D] at (row, head) of a 3-D map into shared memory; completes
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(head)
      : "memory");
}

// Key tiles that rows [r0, r0 + rows) can see (0 when they are all past s_q).
__device__ __forceinline__ int live_key_tiles(int r0, int rows, int s_q, int s_k, int causal) {
  const int n_k = (s_k + TILE - 1) / TILE;
  if (r0 >= s_q) return 0;
  if (!causal) return n_k;
  const int last = min(r0 + rows, s_q);  // exclusive
  return max(0, min((last + s_k - s_q + TILE - 1) / TILE, n_k));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled [rows, D] bf16 tile:
// start address, leading and stride byte offsets (16-byte units) and the
// swizzle mode (1 = 128 B, 2 = 64 B). SBO is the step between 8-row groups;
// LBO is not read for these tiles (one swizzle atom spans the whole D).
template <int D>
__device__ __forceinline__ uint64_t smem_desc(const bf16* tile) {
  constexpr uint64_t row_bytes = D * sizeof(bf16);
  constexpr uint64_t layout = D == 64 ? 1 : 2;
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((8 * row_bytes >> 4) << 32) | (layout << 62);
}

// Descriptor steps of one k16 chunk: 32 bytes along a K-major row, 16 rows
// down an MN-major tile.
__device__ __forceinline__ uint64_t k_major_step(int c) {
  return (uint64_t)(c * 16 * sizeof(bf16)) >> 4;
}
template <int D>
__device__ __forceinline__ uint64_t mn_major_step(int c) {
  return (uint64_t)(c * 16 * D * sizeof(bf16)) >> 4;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The f32 accumulator of a 64 x 64 product as four register-A fragments of
// bf16, one per k16 chunk of the next product.
__device__ __forceinline__ void to_a_fragments(const float (&acc)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[c][i] = pack_bf16(acc[8 * c + 2 * i], acc[8 * c + 2 * i + 1]);
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64]; A in registers (the accumulator
// fragment of a k16 chunk), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 32] += A[64 x 16] * B[16 x 32]; A in registers (the accumulator
// fragment of a k16 chunk), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace
