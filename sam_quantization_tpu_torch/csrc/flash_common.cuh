// What the attention kernels (flash_windowed.cu, flash_global.cu,
// flash_attn.cu) share: their numerics, the problem a block reads, the
// conversions and output stores, and the launch. Their bodies are
// flash_tc.cuh (bfloat16 flash_windowed and flash_global, wgmma),
// probe_tc.cuh (bfloat16 flash_attn, TMA and wgmma) and flash_f32.cuh
// (every float32 build, FFMA). One thread block computes a block of query
// rows of one (problem, head) against all L keys, streamed through shared
// memory in tiles.
//
// Numerics are those of the JAX package's default path
// (sam_quantization_tpu/ops/flash_attention.py:59-187):
//   qs      = round_T(q * (scale * log2 e))            (f32 multiply, T round)
//   rel'    = round_T(rel * log2 e)
//   s[m,n]  = sum_d qs[m,d] k[n,d]  +  (rel_w'[m, n % kw] + rel_h'[m, n // kw])
//   p       = exp2(clip(s, -60, 64) - 64)              (static shift)
//   o       = sum_n round_T(p) v[n] ;  out = round_T(o * (1 / sum_n p))
// or, with the int8 epilogue, out = clip(rint(o * (r * out_inv_scale)), +-127).
// Because the shift is static, streaming the keys needs no online-softmax
// rescale: sum p.v and sum p accumulate in float32 and divide once.
// Keys n >= L do not exist (the port does not pad L), so rows average over
// the L real keys only. Without a rel grid there is no bias term (kh = kw =
// 0) and the bias tiles are not touched.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace samq {

constexpr int MAX_HD = 128;    // the bodies' widest head tile
constexpr float CLAMP_CAP = 64.f;
constexpr float CLAMP_FLOOR = -60.f;
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;  // bytes a block may opt into on sm_90

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round a float32 to T and back (round to nearest even).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename OutT>
__device__ __forceinline__ void store_out(OutT* dst, float o, float r, float ois);
template <> __device__ __forceinline__ void store_out<float>(float* dst, float o, float r, float) {
  *dst = o * r;
}
template <>
__device__ __forceinline__ void store_out<__nv_bfloat16>(__nv_bfloat16* dst, float o, float r,
                                                         float) {
  *dst = __float2bfloat16(o * r);
}
template <> __device__ __forceinline__ void store_out<int8_t>(int8_t* dst, float o, float r,
                                                              float ois) {
  float y = fminf(fmaxf(rintf(o * (r * ois)), -127.f), 127.f);
  *dst = static_cast<int8_t>(y);
}

// Row 0 of one (problem, head); strides are in elements between rows.
template <typename T>
struct Problem {
  const T* q;
  const T* k;
  const T* v;
  const T* rel_h;
  const T* rel_w;
  long q_stride, kv_stride, rel_h_stride, rel_w_stride;
  int L, hd, kh, kw;
  float q_scale;  // softmax scale * log2(e)
};

// Opt the kernel into `bytes` of dynamic shared memory and launch it with
// `threads` threads a block.
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, int threads, size_t bytes, cudaStream_t stream,
                  Args... args) {
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace samq
