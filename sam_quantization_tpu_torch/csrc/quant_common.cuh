// Shared pieces of the packed-weight kernels (quant_matmul.cu, fused_mlp.cu,
// quant_matmul_a8.cu): loading and decoding packed words, filling
// shared-memory tiles of dequantized weights and of activations (float32,
// bfloat16 or int8), and the launch helper.
//
// Layout (sam_quantization_tpu/nn/packed.py, kept word for word): K is split
// into pack blocks of `pb` rows (a power of two <= 128); with PER values per
// int32 word and rpp = pb / PER rows per plane, the word at (block * rpp + i,
// n) holds rows block * pb + s * rpp + i, s = 0..PER-1, at bit s * bits.
// 3-bit weights are a 2-bit plane (qweight, PER 16) and a 1-bit plane
// (qweight_hi, PER 32) with the same pack block: q = low | (hi << 2).
// Dequantization is (float(q) - zero) * scale in float32, with the scale row
// k / groupsize, as the JAX package's _dequant_tile. groupsize is a multiple
// of pb, so one scale and one zero serve a whole word.
//
// Work is organised by word, not by element: a thread loads one word, its
// scale and zero (and the matching high-plane word at 3 bits) and writes
// its PER values, so the unpack costs a few instructions per value. A
// weight tile is KT = 128 rows, a whole number of pack blocks. WeightTile
// splits the load of a tile's words into registers from their decode into
// shared memory, so a kernel can issue the next tile's loads before it
// multiplies the current one; the x tile is copied with cp.async for the
// same reason.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace samq_quant {

constexpr int MAX_SMEM = 232448;  // bytes a block may opt into on sm_90
constexpr int KT = 128;           // K rows per weight tile

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

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
    // word sit in one high-plane word, at bits 2 s + (i >= rpp / 2).
    if constexpr (BITS == 3) hi = __ldg(qw_hi + (long)(kb / 32 + (i & ((rpp >> 1) - 1))) * N + n);
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

// Write the PER dequantized values of a loaded word to out[s * step].
template <int BITS, typename T>
__device__ __forceinline__ void store_word(T* out, int step, int i, int rpp, int word, int hi,
                                           float sc, float zr) {
  const int hs = BITS == 3 && i >= (rpp >> 1);
#pragma unroll
  for (int s = 0; s < Packing<BITS>::PER; ++s)
    out[s * step] = from_f32<T>(dequant(grid_value<BITS>(word, hi, s, hs), zr, sc));
}

// Word row wr of a tile: its in-block word row i and the tile row of its
// pack block (rpp = 2^rl word rows per pack block of pb rows).
__device__ __forceinline__ void locate_row(int wr, int rpp, int rl, int pb, int& i, int& row0) {
  i = wr & (rpp - 1);
  row0 = (wr >> rl) * pb;
}

// A (KT, NC) bfloat16 tile of dequantized weights, rows k0.., columns n0..,
// held as packed words in registers between load() and store(). A thread
// takes the words of two neighbouring columns, so each pair of values is
// converted and stored as one bfloat162. PB: the pack block when it is known
// at compile time (the addresses then fold to constants), else 0. Only
// fused_mlp.cu compiles one in: its decode sits between two barriers per
// tile and a pack block of 128 made it about 2% faster on an H100 at ViT-H
// (PERF.md), while quant_matmul.cu showed no gain beyond run-to-run spread.
template <int BITS, int NC, int NTHREADS, int PB>
struct WeightTile {
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int PAIRS = NC / 2;  // column pairs per word row
  static constexpr int ITEMS = (KT / PER) * PAIRS / NTHREADS;
  static_assert((KT / PER) * PAIRS % NTHREADS == 0, "whole pairs per thread");
  static constexpr int RL = log2i(PB / PER);
  int w0[ITEMS], w1[ITEMS], h0[ITEMS], h1[ITEMS];
  float s0[ITEMS], s1[ITEMS], z0[ITEMS], z1[ITEMS];
  int rpp_, rl_, pb_;

  __device__ __forceinline__ int rpp() const { return PB ? PB / PER : rpp_; }
  __device__ __forceinline__ int rl() const { return PB ? RL : rl_; }
  __device__ __forceinline__ int pb() const { return PB ? PB : pb_; }

  __device__ __forceinline__ void load(const int32_t* __restrict__ qw,
                                       const int32_t* __restrict__ qw_hi,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ zeros, int k0, int K, int n0,
                                       int N, int pack_block, int groupsize) {
    pb_ = pack_block;
    rpp_ = pack_block / PER;
    rl_ = __ffs(rpp_) - 1;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int p = threadIdx.x + it * NTHREADS, n = n0 + 2 * (p % PAIRS);
      int i, row0;
      locate_row(p / PAIRS, rpp(), rl(), pb(), i, row0);
      load_word<BITS>(qw, qw_hi, scales, zeros, k0 + row0, i, rpp(), n, K, N, groupsize, w0[it],
                      h0[it], s0[it], z0[it]);
      load_word<BITS>(qw, qw_hi, scales, zeros, k0 + row0, i, rpp(), n + 1, K, N, groupsize,
                      w1[it], h1[it], s1[it], z1[it]);
    }
  }

  // dst[r * ld + c] = w[k0 + r, n0 + c], zero outside K and N (ld even).
  __device__ __forceinline__ void store(__nv_bfloat16* dst, int ld) const {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int p = threadIdx.x + it * NTHREADS;
      int i, row0;
      locate_row(p / PAIRS, rpp(), rl(), pb(), i, row0);
      __nv_bfloat16* out = dst + (row0 + i) * ld + 2 * (p % PAIRS);
      const int hs = BITS == 3 && i >= (rpp() >> 1);
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        const float v0 = dequant(grid_value<BITS>(w0[it], h0[it], s, hs), z0[it], s0[it]);
        const float v1 = dequant(grid_value<BITS>(w1[it], h1[it], s, hs), z1[it], s1[it]);
        *reinterpret_cast<__nv_bfloat162*>(out + s * rpp() * ld) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
};

// The same tile loaded and stored word by word, for kernels that do not
// overlap the load with other work.
template <typename T, int BITS, int NC, int NTHREADS>
__device__ __forceinline__ void fill_weight_tile(T* dst, int ld, const int32_t* __restrict__ qw,
                                                 const int32_t* __restrict__ qw_hi,
                                                 const float* __restrict__ scales,
                                                 const float* __restrict__ zeros, int k0, int K,
                                                 int n0, int N, int pb, int groupsize) {
  constexpr int PER = Packing<BITS>::PER;
  const int rpp = pb / PER, rl = __ffs(rpp) - 1;
#pragma unroll 4
  for (int w = threadIdx.x; w < (KT / PER) * NC; w += NTHREADS) {
    int i, row0, word, hi;
    float sc, zr;
    const int c = w % NC;
    locate_row(w / NC, rpp, rl, pb, i, row0);
    load_word<BITS>(qw, qw_hi, scales, zeros, k0 + row0, i, rpp, n0 + c, K, N, groupsize, word,
                    hi, sc, zr);
    store_word<BITS>(dst + (row0 + i) * ld + c, rpp * ld, i, rpp, word, hi, sc, zr);
  }
}

// Shared tile dst[r * ld + c] = x[m0 + r, k0 + c] for r < ROWS, c < COLS;
// zero outside M and K. `vec`: 16-byte loads (K a multiple of 16 / sizeof(T)
// and x 16-byte aligned; ld keeps dst rows 16-byte aligned).
template <typename T, int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void fill_x_tile(T* dst, int ld, const T* __restrict__ x, int m0,
                                            int M, int k0, int K, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), NV = COLS / V;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * NV; i += NTHREADS) {
      const int r = i / NV, c = (i % NV) * V, m = m0 + r, k = k0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M && k < K) v = __ldg(reinterpret_cast<const uint4*>(x + (long)m * K + k));
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NTHREADS) {
      const int r = i / COLS, c = i % COLS, m = m0 + r, k = k0 + c;
      dst[r * ld + c] = (m < M && k < K) ? x[(long)m * K + k] : T{};  // T{}: zero bits
    }
  }
}

// The same tile copied with cp.async (16 bytes a copy, zero-filled outside M
// and K) when `vec`, else filled as above; cp_async_wait_all() then a
// __syncthreads() make it visible.
template <typename T, int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void copy_x_tile_async(T* dst, int ld, const T* __restrict__ x,
                                                  int m0, int M, int k0, int K, bool vec) {
  constexpr int V = 16 / sizeof(T), NV = COLS / V;
  static_assert(ROWS * NV % NTHREADS == 0, "whole copies per thread");
  if (!vec) {
    fill_x_tile<T, ROWS, COLS, NTHREADS>(dst, ld, x, m0, M, k0, K, false);
    return;
  }
#pragma unroll
  for (int it = 0; it < ROWS * NV / NTHREADS; ++it) {
    const int idx = threadIdx.x + it * NTHREADS;
    const int r = idx / NV, c = (idx % NV) * V, m = m0 + r, k = k0 + c;
    const bool in = m < M && k < K;
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

// Whether x (row length K) can be staged with 16-byte loads of `per16` values.
inline bool vec_ok(const void* x, int K, int per16) {
  return K % per16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// Whether the packing fields are ones the kernels take (every layout the
// JAX package's pack_int_weights writes).
inline bool packing_ok(int bits, int K, int N, int pb, int groupsize) {
  const int per = bits == 3 ? 32 : (bits == 2 || bits == 4 || bits == 8 ? 32 / bits : 0);
  return per > 0 && K >= 1 && N >= 1 && pb >= per && pb <= KT && (pb & (pb - 1)) == 0 &&
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
