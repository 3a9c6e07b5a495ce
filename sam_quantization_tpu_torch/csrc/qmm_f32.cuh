// Register-tiled float32 body of the packed-weight kernels: out (M, N) =
// epilogue(x (M, K) @ dequant(W) (K, N)) with the products as float32 FFMA
// on the CUDA cores, as JAX's float32 dot computes them (no TF32, no tensor
// core). The interface is the bfloat16 body's (qmm_tc.cuh): quant_matmul.cu
// runs it with the plain epilogue; fused_mlp.cu runs it twice, the first
// time with the +b1 -> gelu_tanh epilogue into an (M, H) float32 scratch.
//
// Numerics: each weight value is dequant() of quant_common.cuh, bit for bit
// the plain version's (whole zero points take a one-subtraction form of it
// that is equal bit for bit); the products are summed in float32 by fmaf,
// so only the order of the sum differs from the plain version.
//
// What bounds it on an H100: qkv at ViT-H (M 4900, K 1280, N 3840, 4-bit)
// is 48.2 GFLOP, 0.72 ms at the 67 TFLOP/s float32 peak, against ~103 MB
// moved (31 us): operations. The CUDA cores' 128 lanes an SM then want a
// shared-memory word for every 4 FMAs or fewer (32 banks), the fills hidden
// behind the products, and the weights decoded few times.
//
// Design. A block is 256 threads and owns a (BM = 128, BN = 128) output
// tile; a thread owns 8 x 8 accumulators, rows rg + 16 i and columns
// 4 cg + j and 64 + 4 cg + j (rg, cg in 0..15; a warp is 4 row groups x 8
// column groups). K is walked in tiles of whole pack blocks (tile_rows(pb)
// rows, at most 128). For each 4 k steps a thread reads 8 float4 of x (its
// rows, 4 k each: x is row-major in shared memory, rows 132 floats apart,
// so a warp's 4 rows fall in distinct banks) and 8 float4 of W (4 k x its 8
// columns: a warp reads 128 contiguous bytes), 64 words for 256 FMAs; a
// full tile's 32 such steps run at a fixed trip count. Shared memory holds
// two x stages (128 x 132 floats each) and one decoded W tile (128 x 128
// floats), 196 KB: two stages of both do not fit. Step t, after one
// barrier:
//   1. the cp.async copy of tile t + 1's x into the other stage starts;
//   2. the FMAs of tile t;
//   3. after a barrier, tile t + 1's words (loaded into registers one step
//      earlier with their scales and zeros) are decoded into the W tile, and
//      tile t + 2's words are loaded, so their latency hides behind tile
//      t + 1's FMAs.
// The weights are decoded M / 128 times in all (39 at qkv, 32 a product in
// the MLP), and step 3 is what the FMAs wait for: the decode is issued by
// the same warps between two barriers. So tiles that are one whole 128-row
// pack block (the default for groups of 128 or more) with N % 4 == 0 take
// Wide: four columns a thread, 16-byte loads of words, scales and zeros and
// 16-byte stores at offsets known at compile time, a third of Words'
// instructions. Other layouts take Words (a word a thread, any pack block,
// any N). A grid that fills the SMs badly (320 blocks: 3 waves of 132, the
// last 42% full) is split along K in two halves that add into a zeroed
// output by atomics, which two terms keep deterministic (the MLP's second
// product). Rows past M are zero-filled by the copy, columns past N decode
// as zeros, and the last K tile may be short (K need not be a whole number
// of tiles); the output is masked. __launch_bounds__(256, 1): one block an
// SM, up to 255 registers a thread, and no spills.
//
// That is the default tile, the one quant_matmul.cu and fused_mlp.cu
// launch. The body is a template on the tile (Tile below: 64 or 128 rows
// and columns; a thread owns TBM / 16 x TBN / 16 accumulators at the same
// rg, cg places). quant_matmul.cu instantiates only the default: the other
// three were slower at every measured ViT-H layer shape (PERF.md), so a
// tuned table has no other float32 tile to name. A thread sums its outputs
// over K in the same order in every tile; only the K split (split_k, which
// looks at the grid) changes the order of an output's sum.
#pragma once

#include <type_traits>

#include "qmm_tc.cuh"

namespace samq_quant {
namespace f32 {

using tc::BIAS_GELU;
using tc::PLAIN;

constexpr int NT = 256;            // threads of a block
constexpr int BM = 128, BN = 128;  // the default output tile
constexpr int XLD = KT + 4;        // float pitch of an x row in shared memory

// A block owns a (TBM, TBN) output tile, a thread TM x TN of it. Shared
// memory: two x stages (TBM x XLD floats) and the decoded W tile (KT x TBN
// floats): 196 KB at the default tile, 130 KB at 64 x 128, 164 KB at
// 128 x 64, and 98 KB at 64 x 64, which alone leaves room for two blocks an
// SM (MINB, the __launch_bounds__ minimum: at most 128 registers a thread).
template <int TBM, int TBN>
struct Tile {
  static_assert((TBM == 64 || TBM == 128) && (TBN == 64 || TBN == 128), "an instantiated tile");
  static constexpr int TM = TBM / 16, TN = TBN / 16;  // a thread's output tile
  static constexpr int X_FLOATS = TBM * XLD;          // one x stage
  static constexpr size_t SMEM = (2 * (size_t)X_FLOATS + (size_t)KT * TBN) * sizeof(float);
  static constexpr int MINB = 2 * (SMEM + 1024) <= tc::SM_SMEM ? 2 : 1;
  static_assert(SMEM <= MAX_SMEM, "shared memory of a block");
};

// Value v of a loaded word, (q - z) * s in float32. Zero points that are
// whole numbers (every RTN and GPTQ grid; WHOLE, bz = z + 2^23, exact) take
// one subtraction, as qmm_tc.cuh's decode: (2^23 + q) - bz is q - z
// exactly, as float(q) - z is; other zeros take dequant()'s two.
template <int BITS, bool WHOLE>
__device__ __forceinline__ float decode(int word, int hi, int v, int hs, float sc, float zr,
                                        float bz) {
  const int q = grid_value<BITS>(word, hi, v, hs);
  return WHOLE ? __fmul_rn(__fsub_rn(__int_as_float(0x4B000000 | q), bz), sc)
               : dequant(q, zr, sc);
}

__device__ __forceinline__ bool whole(float z) { return z == rintf(z) && fabsf(z) < 4194304.f; }

// The packed words of one weight tile, loaded a step ahead. Item it of a
// thread is word row (NT / TBN) it + tid / TBN of column tid % TBN, so a
// warp's loads and its decoded stores each cover 32 consecutive columns.
template <int BITS, int TBN>
struct Words {
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int ITEMS = (KT / PER) * TBN / NT;
  static_assert((KT / PER) * TBN % NT == 0, "whole items");
  int w[ITEMS], h[ITEMS];
  float s[ITEMS], z[ITEMS];

  // Walk the thread's word rows: fn(it, i, row0) with i the in-block word
  // row and row0 the tile row of its pack block, for word rows inside kt.
  template <typename Fn>
  static __device__ __forceinline__ void walk(int pb, int kt, Fn fn) {
    const int rpp = pb / PER;
    int i, row0;
    locate_row(threadIdx.x / TBN, rpp, pb, i, row0);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      if (it * (NT / TBN) + threadIdx.x / TBN >= kt / PER) break;
      fn(it, i, row0);
      i += NT / TBN;
      while (i >= rpp) i -= rpp, row0 += pb;
    }
  }

  __device__ __forceinline__ void load(const int32_t* __restrict__ qw,
                                       const int32_t* __restrict__ qw_hi,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ zeros, int k0, int K, int n0,
                                       int N, int pb, int groupsize, int kt) {
    const int rpp = pb / PER, n = n0 + threadIdx.x % TBN;
    walk(pb, kt, [&](int it, int i, int row0) {
      load_word<BITS>(qw, qw_hi, scales, zeros, k0 + row0, i, rpp, n, K, N, groupsize, w[it],
                      h[it], s[it], z[it]);
    });
  }

  // Decode the loaded words into the W tile (row-major, TBN floats a row).
  __device__ __forceinline__ void store(float* ws, int pb, int kt) const {
    const int rpp = pb / PER, c = threadIdx.x % TBN;
    walk(pb, kt, [&](int it, int i, int row0) {
      float* dst = ws + (row0 + i) * TBN + c;
      const int hs = BITS == 3 && i >= (rpp >> 1);
      const float sc = s[it], zr = z[it], bz = zr + 8388608.f;
      if (whole(zr)) {
#pragma unroll
        for (int v = 0; v < PER; ++v)
          dst[v * rpp * TBN] = decode<BITS, true>(w[it], h[it], v, hs, sc, zr, bz);
      } else {
#pragma unroll
        for (int v = 0; v < PER; ++v)
          dst[v * rpp * TBN] = decode<BITS, false>(w[it], h[it], v, hs, sc, zr, bz);
      }
    });
  }
};

// The words of tiles that are one whole pack block of 128 rows, N % 4 == 0
// (the main path's layers): item it of a thread is word row tid / CG +
// (NT / CG) it of the 4 columns 4 (tid % CG), CG = TBN / 4 column groups
// (32 at the default tile), one 16-byte load of words; the tile is one
// group row, so a thread loads one 16-byte scale and zero row, and stores
// each value plane with one 16-byte store at an offset known at compile
// time. Same values as Words, in fewer instructions. Where a tile has fewer
// word rows than NT / CG (2- and 3-bit words at 64 columns) the threads past
// them are idle.
template <int BITS, int TBN>
struct Wide {
  static constexpr int PER = Packing<BITS>::PER, RPP = KT / PER;  // word rows of a tile
  static constexpr int CG = TBN / 4, ROWS = NT / CG;              // column groups; rows a pass
  static constexpr int ITEMS = (RPP + ROWS - 1) / ROWS;
  static constexpr bool EVEN = RPP % ROWS == 0;  // every item of every thread is a word row
  static_assert(NT % CG == 0, "whole rows a pass");
  int4 w[ITEMS], h[ITEMS];
  float4 s, z;

  __device__ __forceinline__ void load(const int32_t* __restrict__ qw,
                                       const int32_t* __restrict__ qw_hi,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ zeros, int k0, int, int n0,
                                       int N, int, int groupsize, int) {
    const int n = n0 + 4 * (threadIdx.x % CG), wr0 = threadIdx.x / CG;
    const bool in = n < N;  // N % 4 == 0: all four columns or none
    const int4 zero4 = make_int4(0, 0, 0, 0);
    s = z = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) {
      const long gi = (long)(k0 / groupsize) * N + n;
      s = __ldg(reinterpret_cast<const float4*>(scales + gi));
      z = __ldg(reinterpret_cast<const float4*>(zeros + gi));
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int wr = wr0 + ROWS * it;
      if (!EVEN && wr >= RPP) continue;
      w[it] = in ? __ldg(reinterpret_cast<const int4*>(qw + (long)(k0 / PER + wr) * N + n))
                 : zero4;
      if constexpr (BITS == 3) {
        const int hr = k0 / 32 + (wr >= RPP / 2 ? wr - RPP / 2 : wr);
        h[it] = in ? __ldg(reinterpret_cast<const int4*>(qw_hi + (long)hr * N + n)) : zero4;
      }
    }
  }

  template <bool WHOLE>
  __device__ __forceinline__ void planes(float* ws) const {
    const float4 bz = make_float4(z.x + 8388608.f, z.y + 8388608.f, z.z + 8388608.f,
                                  z.w + 8388608.f);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int wr = threadIdx.x / CG + ROWS * it, hs = BITS == 3 && wr >= RPP / 2;
      if (!EVEN && wr >= RPP) continue;
      float* dst = ws + wr * TBN + 4 * (threadIdx.x % CG);
      const int4 wd = w[it], hd = BITS == 3 ? h[it] : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int v = 0; v < PER; ++v)
        *reinterpret_cast<float4*>(dst + v * RPP * TBN) =
            make_float4(decode<BITS, WHOLE>(wd.x, hd.x, v, hs, s.x, z.x, bz.x),
                        decode<BITS, WHOLE>(wd.y, hd.y, v, hs, s.y, z.y, bz.y),
                        decode<BITS, WHOLE>(wd.z, hd.z, v, hs, s.z, z.z, bz.z),
                        decode<BITS, WHOLE>(wd.w, hd.w, v, hs, s.w, z.w, bz.w));
    }
  }

  __device__ __forceinline__ void store(float* ws, int, int) const {
    if (whole(z.x) && whole(z.y) && whole(z.z) && whole(z.w)) planes<true>(ws);
    else planes<false>(ws);
  }
};

// One (TBM, TBN) output tile. WIDE: the words by Wide (pb == KT, N % 4 ==
// 0, aligned), else by Words. `vec`: x may be copied 16 bytes at a time
// (vec_ok); `vec_out`: N % 4 == 0 and out 16-byte aligned. bias: float32
// (N,), read by the BIAS_GELU epilogue only.
template <int BITS, int EPI, bool WIDE, int TBM, int TBN>
__global__ void __launch_bounds__(NT, Tile<TBM, TBN>::MINB)
    qmm_f32_kernel(const float* __restrict__ x, const int32_t* __restrict__ qw,
                   const int32_t* __restrict__ qw_hi, const float* __restrict__ scales,
                   const float* __restrict__ zeros, const float* __restrict__ bias,
                   float* __restrict__ out, int M, int K, int N, int pb, int groupsize,
                   int kchunk, bool vec, bool vec_out) {
  using Tl = Tile<TBM, TBN>;
  constexpr int TM = Tl::TM, TN = Tl::TN, X_FLOATS = Tl::X_FLOATS;
  extern __shared__ __align__(128) unsigned char f32_smem[];
  float* const smem = reinterpret_cast<float*>(f32_smem);
  float* const ws = smem + 2 * X_FLOATS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = (warp >> 1) * 4 + (lane >> 3), cg = (warp & 1) * 8 + (lane & 7);
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  // K rows [kb, kb + kchunk) of this block: all of K, or one of two halves
  // of whole tiles when the grid is split along K (blockIdx.z).
  const int kt = tile_rows(pb), kb = blockIdx.z * kchunk;
  const int tiles = (min(K, kb + kchunk) - kb + kt - 1) / kt;
  auto xs = [&](int t) { return smem + (t & 1) * X_FLOATS; };
  auto copy_x = [&](int t) {
    copy_x_tile_async<float, TBM, KT, NT>(xs(t), XLD, x, m0, M, kb + t * kt, K, kt, vec);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  std::conditional_t<WIDE, Wide<BITS, TBN>, Words<BITS, TBN>> wd;
  auto load = [&](int t) {
    wd.load(qw, qw_hi, scales, zeros, kb + t * kt, K, n0, N, pb, groupsize, kt);
  };
  copy_x(0);
  load(0);
  wd.store(ws, pb, kt);
  if (tiles > 1) load(1);

  for (int t = 0; t < tiles; ++t) {
    // Tile t's x and W are in place; every thread is done with tile t - 1.
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < tiles) copy_x(t + 1);
    const float* xa = xs(t) + rg * XLD;
    const float* wb = ws + 4 * cg;
    const int klen = min(kt, K - kb - t * kt);  // a multiple of 4 (whole pack blocks)
    auto fma4 = [&](int kk) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(xa + 16 * i * XLD + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 bh = *reinterpret_cast<const float4*>(wb + (kk + q) * TBN + 64 * h);
          b[4 * h] = bh.x, b[4 * h + 1] = bh.y, b[4 * h + 2] = bh.z, b[4 * h + 3] = bh.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    };
    if (klen == KT) {  // a fixed trip count: ptxas schedules it better
#pragma unroll 4
      for (int kk = 0; kk < KT; kk += 4) fma4(kk);
    } else {
#pragma unroll 1
      for (int kk = 0; kk < klen; kk += 4) fma4(kk);
    }
    if (t + 1 < tiles) {
      __syncthreads();  // every thread is done with tile t's W
      wd.store(ws, pb, kt);
      if (t + 2 < tiles) load(t + 2);
    }
  }

  // Epilogue: row m0 + rg + 16 i, columns n0 + 64 h + 4 cg + e.
#pragma unroll
  for (int h = 0; h < TN / 4; ++h) {
    const int n = n0 + 64 * h + 4 * cg;
    float b[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (EPI == BIAS_GELU) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) b[e] = __ldg(bias + n + e);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + rg + 16 * i;
      if (m >= M || n >= N) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][4 * h + e];
        if constexpr (EPI == BIAS_GELU) v[e] = gelu_tanh(__fadd_rn(v[e], b[e]));
      }
      float* dst = out + (long)m * N + n;
      if (gridDim.z > 1) {  // the two K halves add into a zeroed out: 0 + a + b either way
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) atomicAdd(dst + e, v[e]);
      } else if (vec_out) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) dst[e] = v[e];
      }
    }
  }
}

// 2 where splitting K in two halves fills the card's SMs (one block an SM)
// better: a grid of 320 blocks on 132 SMs runs 3 waves, the last 42% full;
// 640 run 5 waves at 97%. The halves add into a zeroed output by atomics,
// which two terms keep deterministic; the GELU epilogue cannot be split.
inline int split_k(long blocks, int tiles, int epi) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 1;
  }
  if (epi != PLAIN || tiles < 2 || sms <= 0) return 1;
  auto fill = [&](long b) { return (double)b / (double)(((b + sms - 1) / sms) * sms); };
  return fill(2 * blocks) > fill(blocks) + 0.05 ? 2 : 1;
}

// Launch the body with a (TBM, TBN) tile on x (M, K) float32 -> out (M, N)
// float32.
template <int BITS, int EPI, int TBM = BM, int TBN = BN>
inline int run(const float* x, const int32_t* qw, const int32_t* qw_hi, const float* scales,
               const float* zeros, const float* bias, float* out, int M, int K, int N, int pb,
               int groupsize, cudaStream_t stream) {
  if ((N + TBN - 1) / TBN > 65535) return (int)cudaErrorInvalidValue;
  const int kt = tile_rows(pb), tiles = (K + kt - 1) / kt;
  const bool vec = vec_ok(x, K, kt, 4);
  const bool vec_out = N % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long blocks = (long)((M + TBM - 1) / TBM) * ((N + TBN - 1) / TBN);
  const dim3 grid((M + TBM - 1) / TBM, (N + TBN - 1) / TBN, split_k(blocks, tiles, EPI));
  const int kchunk = (tiles + grid.z - 1) / grid.z * kt;
  if (grid.z > 1) {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
  }
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (pb == KT && N % 4 == 0 && a16(qw) && a16(scales) && a16(zeros) && (BITS != 3 || a16(qw_hi)))
    return launch(qmm_f32_kernel<BITS, EPI, true, TBM, TBN>, grid, NT, Tile<TBM, TBN>::SMEM,
                  stream, x, qw, qw_hi, scales, zeros, bias, out, M, K, N, pb, groupsize, kchunk,
                  vec, vec_out);
  return launch(qmm_f32_kernel<BITS, EPI, false, TBM, TBN>, grid, NT, Tile<TBM, TBN>::SMEM,
                stream, x, qw, qw_hi, scales, zeros, bias, out, M, K, N, pb, groupsize, kchunk,
                vec, vec_out);
}

}  // namespace f32
}  // namespace samq_quant
