// Shared pieces of the packed-weight kernels (quant_matmul.cu, fused_mlp.cu,
// quant_matmul_a8.cu, qmm_tc.cuh, qmm_f32.cuh): loading and decoding packed
// words, filling shared-memory tiles of activations (float32, bfloat16 or
// int8), and the launch helper.
//
// Layout (sam_quantization_tpu/nn/packed.py, kept word for word): K is split
// into pack blocks of `pb` rows (a multiple of the values per word, at most
// 128, not always a power of two: default_pack_block gives 48 for groups of
// 48, 12 for groups of 12 at 8 bits, 96 for groups of 96 at 3 bits); with
// PER values per int32 word and rpp = pb / PER rows per plane, the word at
// (block * rpp + i, n) holds rows block * pb + s * rpp + i, s = 0..PER-1, at
// bit s * bits. 3-bit weights are a 2-bit plane (qweight, PER 16) and a
// 1-bit plane (qweight_hi, PER 32) with the same pack block: q = low |
// (hi << 2). Dequantization is (float(q) - zero) * scale in float32, with
// the scale row k / groupsize, as the JAX package's _dequant_tile.
// groupsize is a multiple of pb, so one scale and one zero serve a whole
// word.
//
// K tiles are whole pack blocks: tile_rows(pb) rows, the most whole blocks
// that fit in KT = 128 (pb 48 gives 96, pb 12 gives 120). Word addresses
// divide by rpp (locate_row), so no power of two is assumed. Work is
// organised by word, not by element: a thread loads one word, its scale and
// zero (and the matching high-plane word at 3 bits) and writes its PER
// values, so the unpack costs a few instructions per value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace samq_quant {

constexpr int MAX_SMEM = 232448;  // bytes a block may opt into on sm_90
constexpr int KT = 128;           // most K rows of a weight tile

// K rows of a weight tile: the most whole pack blocks that fit in KT, an
// even number of them where pb is not a multiple of 8, so that every tile
// starts on a 16-byte boundary of an x row (pb 68, 76, ..., 124 cannot and
// take one block; their x tiles are copied value by value).
__host__ __device__ __forceinline__ int tile_rows(int pb) {
  int n = KT / pb;
  if (n > 1 && (pb * n) % 8) --n;
  return pb * n;
}

template <int BITS>
struct Packing {
  static constexpr int PER = BITS == 3 ? 16 : 32 / BITS;   // values per (low-plane) word
  static constexpr int LBITS = BITS == 3 ? 2 : BITS;       // bits per value in that word
  static constexpr int MASK = (1 << LBITS) - 1;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Load the word at in-block word row i of the pack block whose first row is
// kb, column n, with its scale and zero (and the high-plane word at 3 bits).
// Outside K or N everything is 0, which decodes to zeros.
template <int BITS>
__device__ __forceinline__ void load_word(const int32_t* __restrict__ qw,
                                          const int32_t* __restrict__ qw_hi,
                                          const float* __restrict__ scales,
                                          const float* __restrict__ zeros, int kb, int i,
                                          int rpp, int n, int K, int N, int groupsize, int& word,
                                          int& hi, float& sc, float& zr) {
  word = hi = 0;
  sc = zr = 0.f;
  if (kb < K && n < N) {
    word = __ldg(qw + (long)(kb / Packing<BITS>::PER + i) * N + n);
    // The high plane has half as many rows per plane: the 16 values of this
    // word sit in one high-plane word, word row i mod (rpp / 2), at bits
    // 2 s + (i >= rpp / 2).
    if constexpr (BITS == 3) {
      const int half = rpp >> 1;
      hi = __ldg(qw_hi + (long)(kb / 32 + (i >= half ? i - half : i)) * N + n);
    }
    const long gi = (long)(kb / groupsize) * N + n;
    sc = __ldg(scales + gi);
    zr = __ldg(zeros + gi);
  }
}

// float(q) for 0 <= q < 2^23 without a conversion instruction (conversions
// issue at a fraction of the float rate): the bits of 2^23 + q, less 2^23,
// both exact. Then (q - z) * s in float32, two roundings, never an FMA.
__device__ __forceinline__ float dequant(int q, float zr, float sc) {
  const float fq = __fsub_rn(__int_as_float(0x4B000000 | q), 8388608.f);
  return __fmul_rn(__fsub_rn(fq, zr), sc);
}

// Grid value s of a loaded word (hs: which half of the high-plane word, at 3
// bits). The shift comes before the mask, so the arithmetic >> of a negative
// word is harmless.
template <int BITS>
__device__ __forceinline__ int grid_value(int word, int hi, int s, int hs) {
  using P = Packing<BITS>;
  int q = (word >> (s * P::LBITS)) & P::MASK;
  if constexpr (BITS == 3) q |= ((hi >> (2 * s + hs)) & 1) << 2;
  return q;
}

// Word row wr of a tile: its in-block word row i and the tile row of its
// pack block (rpp word rows per pack block of pb rows).
__device__ __forceinline__ void locate_row(int wr, int rpp, int pb, int& i, int& row0) {
  const int blk = wr / rpp;
  i = wr - blk * rpp;
  row0 = blk * pb;
}

// Shared tile dst[r * ld + c] = x[m0 + r, k0 + c] for r < ROWS, c < COLS;
// zero outside M and K and from column kt (the tile's rows of K) on. `vec`:
// 16-byte loads (K and kt multiples of 16 / sizeof(T), x 16-byte aligned; ld
// keeps dst rows 16-byte aligned).
template <typename T, int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void fill_x_tile(T* dst, int ld, const T* __restrict__ x, int m0,
                                            int M, int k0, int K, int kt, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), NV = COLS / V;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * NV; i += NTHREADS) {
      const int r = i / NV, c = (i % NV) * V, m = m0 + r, k = k0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M && c < kt && k < K) v = __ldg(reinterpret_cast<const uint4*>(x + (long)m * K + k));
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NTHREADS) {
      const int r = i / COLS, c = i % COLS, m = m0 + r, k = k0 + c;
      dst[r * ld + c] = (m < M && c < kt && k < K) ? x[(long)m * K + k] : T{};  // T{}: zero bits
    }
  }
}

// The same tile copied with cp.async (16 bytes a copy, zero-filled where
// fill_x_tile writes zeros) when `vec`, else filled as above;
// cp_async_wait_all() then a __syncthreads() make it visible.
template <typename T, int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void copy_x_tile_async(T* dst, int ld, const T* __restrict__ x,
                                                  int m0, int M, int k0, int K, int kt, bool vec) {
  constexpr int V = 16 / sizeof(T), NV = COLS / V;
  static_assert(ROWS * NV % NTHREADS == 0, "whole copies per thread");
  if (!vec) {
    fill_x_tile<T, ROWS, COLS, NTHREADS>(dst, ld, x, m0, M, k0, K, kt, false);
    return;
  }
#pragma unroll
  for (int it = 0; it < ROWS * NV / NTHREADS; ++it) {
    const int idx = threadIdx.x + it * NTHREADS;
    const int r = idx / NV, c = (idx % NV) * V, m = m0 + r, k = k0 + c;
    const bool in = m < M && c < kt && k < K;
    const T* src = in ? x + (long)m * K + k : x;
    const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
                 "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Whether x (row length K) can be staged with 16-byte loads of `per16`
// values, in K tiles of kt rows.
inline bool vec_ok(const void* x, int K, int kt, int per16) {
  return K % per16 == 0 && kt % per16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// Whether the packing fields are ones the kernels take: every layout the
// JAX package's pack_int_weights writes (a pack block that is a multiple of
// the values per word, at most 128, and divides the groupsize and K).
inline bool packing_ok(int bits, int K, int N, int pb, int groupsize) {
  const int per = bits == 3 ? 32 : (bits == 2 || bits == 4 || bits == 8 ? 32 / bits : 0);
  return per > 0 && K >= 1 && N >= 1 && pb >= per && pb <= KT && pb % per == 0 &&
         K % pb == 0 && groupsize >= pb && groupsize % pb == 0 && K % groupsize == 0;
}

// Opt the kernel into `bytes` of dynamic shared memory and launch it;
// returns the launch's CUDA error.
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

}  // namespace samq_quant
