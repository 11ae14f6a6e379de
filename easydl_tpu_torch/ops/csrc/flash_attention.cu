// Flash attention for Hopper (sm_90a): the C entry points of every flash
// kernel, reached from easydl_tpu_torch/ops/flash_attention.py through ctypes.
//
// The kernels replace the three pallas_calls of
// easydl_tpu/ops/flash_attention.py (_fwd_kernel, _bwd_dq_kernel,
// _bwd_dkv_kernel), all on the tensor cores: in bf16, GPT's training path,
// the wgmma kernels of flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu and
// flash_bwd_dkv_sm90.cu; in f32, BERT's, the 3xTF32 mma.sync kernels of
// flash_fwd_f32_sm90.cu and flash_bwd_f32_sm90.cu. The entry points below
// reach each of them by dtype.
//
// Layout: q and O [bh, s_q, d], k and v [bh, s_k, d], all contiguous; lse
// [bh, s_q] in f32. The softmax scale is folded into q. Causal masking is
// bottom-right aligned: row r sees column c iff r + (s_k - s_q) >= c.
// Rows that see no key write O = 0 and lse = +FLT_MAX, so the backward's
// exp(s - lse) is exactly 0 for them. Ragged tails (s not a multiple of the
// 64-row tile) are masked in the kernels, so no length needs a fallback.
//
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

// The bf16 tensor-core kernels (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu,
// flash_bwd_dkv_sm90.cu) and the f32 ones (flash_fwd_f32_sm90.cu,
// flash_bwd_f32_sm90.cu).
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
cudaError_t flash_fwd_f32_sm90(int head_dim, const void* q, const void* k, const void* v, void* o,
                               void* lse, int bh, int s_q, int s_k, int causal, float scale,
                               cudaStream_t stream);
cudaError_t flash_bwd_dkv_f32_sm90(int head_dim, const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, int bh, int s_q, int s_k, int causal,
                                   float scale, cudaStream_t stream);
cudaError_t flash_bwd_dq_f32_sm90(int head_dim, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const void* lse, void* delta,
                                  void* dq, int bh, int s_q, int s_k, int causal, float scale,
                                  cudaStream_t stream);
int flash_fwd_sm90_ctas_per_sm(int head_dim);
int flash_bwd_dkv_sm90_ctas_per_sm(int head_dim);
int flash_bwd_dq_sm90_ctas_per_sm(int head_dim);
int flash_bwd_dkv_f32_sm90_ctas_per_sm(int head_dim);
int flash_bwd_dq_f32_sm90_ctas_per_sm(int head_dim);
int flash_fwd_f32_sm90_ctas_per_sm(int head_dim);

// dtype: 0 = float32, 1 = bfloat16. head_dim: 32 or 64. Anything else is
// refused with cudaErrorInvalidValue; the Python wrapper checks first.
extern "C" {

const char* easydl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// CTAs per SM of a tensor-core kernel (bf16: 0 = forward, 1 = dk/dv, 2 = dq;
// f32: 3 = dk/dv, 4 = dq, 5 = forward), -1 on error.
int easydl_flash_sm90_ctas_per_sm(int kernel, int head_dim) {
  return kernel == 0   ? flash_fwd_sm90_ctas_per_sm(head_dim)
         : kernel == 1 ? flash_bwd_dkv_sm90_ctas_per_sm(head_dim)
         : kernel == 2 ? flash_bwd_dq_sm90_ctas_per_sm(head_dim)
         : kernel == 3 ? flash_bwd_dkv_f32_sm90_ctas_per_sm(head_dim)
         : kernel == 4 ? flash_bwd_dq_f32_sm90_ctas_per_sm(head_dim)
         : kernel == 5 ? flash_fwd_f32_sm90_ctas_per_sm(head_dim)
                       : -1;
}

int easydl_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                     void* o, void* lse, int bh, int s_q, int s_k, int causal, float scale,
                     void* stream) {
  if (dtype == 0)
    return (int)flash_fwd_f32_sm90(head_dim, q, k, v, o, lse, bh, s_q, s_k, causal, scale,
                                   (cudaStream_t)stream);
  if (dtype == 1)
    return (int)flash_fwd_sm90(head_dim, q, k, v, o, lse, bh, s_q, s_k, causal, scale,
                               (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// dq and delta = rowsum(dO∘O) (written for flash_bwd_dkv).
int easydl_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse, void* delta, void* dq,
                        int bh, int s_q, int s_k, int causal, float scale, void* stream) {
  if (dtype == 0)
    return (int)flash_bwd_dq_f32_sm90(head_dim, q, k, v, o, dout, lse, delta, dq, bh, s_q, s_k,
                                      causal, scale, (cudaStream_t)stream);
  if (dtype == 1)
    return (int)flash_bwd_dq_sm90(head_dim, q, k, v, o, dout, lse, delta, dq, bh, s_q, s_k,
                                  causal, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

int easydl_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                         int bh, int s_q, int s_k, int causal, float scale, void* stream) {
  if (dtype == 0)
    return (int)flash_bwd_dkv_f32_sm90(head_dim, q, k, v, dout, lse, delta, dk, dv, bh, s_q,
                                       s_k, causal, scale, (cudaStream_t)stream);
  if (dtype == 1)
    return (int)flash_bwd_dkv_sm90(head_dim, q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_k,
                                   causal, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
