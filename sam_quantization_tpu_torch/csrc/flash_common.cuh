// Shared body of the attention kernels (flash_windowed.cu, flash_global.cu,
// flash_attn.cu): one thread block computes BQ query rows of one
// (problem, head) against all L keys, streamed through shared memory in
// tiles of BK keys.
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
// the L real keys only. With REL false there is no bias term: kh = kw = 0,
// and neither the bias tiles nor the n // kw, n % kw index rows are touched.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace samq {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per streamed tile
constexpr int NTHREADS = 256;  // 16 x 16 threads; each holds 4 rows x 4 keys
constexpr int MAX_HD = 128;    // 8 column groups of 16 in the output tile
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

__host__ __device__ inline size_t smem_floats(int hd, int kh, int kw) {
  const int ld = hd + 1;  // odd row pitch: the 16 key rows a warp reads hit 16 banks
  return (size_t)BQ * ld + (size_t)BK * ld + (size_t)BK * hd + (size_t)BQ * (BK + 1) +
         (size_t)BQ * kh + (size_t)BQ * kw + 2 * BK;  // + two int index rows
}

inline size_t smem_bytes(int hd, int kh, int kw) { return smem_floats(hd, kh, kw) * 4; }

template <typename T, typename OutT, bool REL = true>
__device__ void attend_rows(const Problem<T>& P, int m0, OutT* out, long out_stride, float ois) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int L = P.L, hd = P.hd, kh = P.kh, kw = P.kw, ld = hd + 1;
  float* Qs = smem;                  // BQ x ld, scaled and rounded q
  float* Ks = Qs + BQ * ld;          // BK x ld
  float* Vs = Ks + BK * ld;          // BK x hd
  float* Ps = Vs + BK * hd;          // BQ x (BK + 1), round_T(p)
  float* Rh = Ps + BQ * (BK + 1);    // BQ x kh, rel_h * log2 e
  float* Rw = Rh + BQ * kh;          // BQ x kw
  int* colh = reinterpret_cast<int*>(Rw + BQ * kw);  // n // kw for the tile
  int* colw = colh + BK;                             // n % kw

  for (int i = tid; i < BQ * hd; i += NTHREADS) {
    const int r = i / hd, c = i - r * hd, m = m0 + r;
    Qs[r * ld + c] = m < L ? round_to<T>(to_f32(P.q[(long)m * P.q_stride + c]) * P.q_scale) : 0.f;
  }
  if constexpr (REL) {
    for (int i = tid; i < BQ * kh; i += NTHREADS) {
      const int r = i / kh, c = i - r * kh, m = m0 + r;
      Rh[i] = m < L ? round_to<T>(to_f32(P.rel_h[(long)m * P.rel_h_stride + c]) * LOG2E_F) : 0.f;
    }
    for (int i = tid; i < BQ * kw; i += NTHREADS) {
      const int r = i / kw, c = i - r * kw, m = m0 + r;
      Rw[i] = m < L ? round_to<T>(to_f32(P.rel_w[(long)m * P.rel_w_stride + c]) * LOG2E_F) : 0.f;
    }
  }

  float acc[4][MAX_HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_HD / 16; ++j) acc[i][j] = 0.f;
  float lsum[4] = {0.f, 0.f, 0.f, 0.f};

  for (int n0 = 0; n0 < L; n0 += BK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int i = tid; i < BK * hd; i += NTHREADS) {
      const int r = i / hd, c = i - r * hd, n = n0 + r;
      float kv = 0.f, vv = 0.f;
      if (n < L) {
        kv = to_f32(P.k[(long)n * P.kv_stride + c]);
        vv = to_f32(P.v[(long)n * P.kv_stride + c]);
      }
      Ks[r * ld + c] = kv;
      Vs[r * hd + c] = vv;
    }
    if constexpr (REL) {
      if (tid < BK) {
        const int n = n0 + tid, hq = n / kw;
        colh[tid] = hq;
        colw[tid] = n - hq * kw;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    if constexpr (REL) {
      for (int d = 0; d < hd; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    } else {
      // The same loop with an explicit unroll: left to itself nvcc unrolled the
      // rel-less instantiation less, and it ran about 1.7x slower than the
      // rel one. The rel instantiations keep nvcc's own choice, which is
      // faster for flash_windowed.
#pragma unroll 8
      for (int d = 0; d < hd; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = 0.f;
        if (n0 + c < L) {
          float x = s[i][j];
          if constexpr (REL) x += Rw[r * kw + colw[c]] + Rh[r * kh + colh[c]];
          x = fminf(fmaxf(x, CLAMP_FLOOR), CLAMP_CAP);
          p = exp2f(x - CLAMP_CAP);
          lsum[i] += p;
          p = round_to<T>(p);
        }
        Ps[r * (BK + 1) + c] = p;
      }
    }
    __syncthreads();

    const int nk = min(BK, L - n0);
    for (int n = 0; n < nk; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + n];
#pragma unroll
      for (int j = 0; j < MAX_HD / 16; ++j) {
        const int c = tx + 16 * j;
        if (c < hd) {
          const float vv = Vs[n * hd + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  // Row sums: the 16 threads of one row group are lanes tx = 0..15 of a half warp.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], off);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= L) continue;
    const float r = 1.f / lsum[i];
#pragma unroll
    for (int j = 0; j < MAX_HD / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) store_out<OutT>(out + (long)m * out_stride + c, acc[i][j], r, ois);
    }
  }
}

// Opt the kernel into `bytes` of dynamic shared memory and launch it.
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, size_t bytes, cudaStream_t stream, Args... args) {
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace samq
