// Tensor-core body of the bfloat16 packed-weight kernels: out (M, N) =
// epilogue(x (M, K) @ dequant(W) (K, N)) with the products on Hopper's
// warpgroup MMA (wgmma), float32 accumulators in registers. quant_matmul.cu
// runs it with the plain epilogue (round to bf16); fused_mlp.cu runs it
// twice, the first time with the +b1 -> gelu_tanh -> round epilogue.
//
// Numerics: each weight value is (float(q) - z) * s in float32, rounded to
// bf16 (dequant() of quant_common.cuh, bit for bit the plain version's),
// products summed in float32 (only the order of the sum differs from the
// plain version), the output rounded to bf16.
//
// What bounds it on an H100 (qkv at ViT-H: M 4900, K 1280, N 3840, 4-bit):
// 48.2 GFLOP against ~53 MB moved, 49 us of bf16 tensor-core time against
// 16 us of memory, so operations. But the weights are 4.92 M values that
// every row block decodes again, M / 256 = 20 times at about 5
// instructions a value, and the x tile of every output tile streams from
// L2: both have to keep up with the tensor cores.
//
// Design. A block is four warpgroups (512 threads) and owns a (BM = 256,
// BN = 128) output tile; warpgroup w owns rows 64 w.. and issues
// wgmma.m64n128k16 with both operands in shared memory. That is the default
// tile, the one quant_matmul.cu and fused_mlp.cu launch; the body is a
// template on the tile (Tile below: 128 or 256 rows, 64 or 128 columns),
// and quant_matmul.cu also instantiates 256 x 64 for a tuned table
// (ops/autotune.py). Every tile walks K alike, so each output is the same
// chain of k16 products whatever the tile. K is walked in
// tiles of whole pack blocks (tile_rows(pb): 128 rows at pb 128, 96 at 48,
// 120 at 12); a tile of fewer than 128 rows leaves zero rows in the weight
// tile and zero columns in the x tile, so every tile runs the same chain of
// eight k16 products. Both operands use the 128-byte swizzle (x K-major, W
// MN-major, since W is (K, N) row-major; x_off and w_off below). A stage of
// the two-stage ring holds the x tile (64 KB) and the decoded weight tile
// (32 KB). x tiles of 128 rows arrive by TMA (one thread, an mbarrier per
// stage, rows past M and columns past K zero-filled); other tiles, and x
// that TMA cannot address, by cp.async. Step t, after one barrier:
//   1. the x copy of tile t + 1 starts;
//   2. the warpgroups issue tile t's chain of eight wgmma;
//   3. every thread decodes tile t + 1's words (loaded with their scales
//      and zeros one step earlier) into the other stage: a thread takes one
//      word row of two neighbouring columns and writes PER bf16 pairs; the
//      32 lanes of a warp take 8 word rows x 8 columns, so each of their
//      stores fills distinct banks;
//   4. every thread loads tile t + 2's words, then waits for its chain.
// Zero points that are whole numbers take one subtraction a value (store()
// below), and the word rows, their in-block row and tile offset are fixed
// per thread and computed once, so no division is in the loop but the group
// index (a shift when the groupsize is a power of two). The epilogue stages
// the bf16 tile in the freed ring (rows padded to 4 banks apart) and writes
// 16-byte rows, with ragged M and N masked.
//
// A warp that issues a wgmma chain waits while the tensor cores take it, so
// step 3 mostly follows the products instead of running beside them. Tried
// on the card and not kept (each slower than this form): the non-swizzled
// core-matrix layout of flash_tc.cuh; x by cp.async for every tile; the
// decode split into the gaps between the chain's links; warpgroup pairs
// taking turns between products and decode; blocks of 128 rows (two
// warpgroups; twice the decode); and a producer warpgroup that decodes
// beside consumers that only multiply: four consumers and one or two
// producers (640 or 768 threads leave 96 or 80 registers a thread: the
// accumulators spilled, or did not compile, and ptxas kept the limit under
// setmaxnreg), or two consumers of 128 rows and one producer (384 threads,
// 168 registers: correct, but spilling a kilobyte a thread). Not tried: the
// register-A form (out^T = W^T x^T, decoded weights as wgmma's register
// operand, as published Hopper mixed-input GEMMs do), whose fragment order
// the block-planar layout does not match.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <string.h>

#include "quant_common.cuh"
#include "tma.cuh"

namespace samq_quant {

__device__ __forceinline__ float gelu_tanh(float a) {
  // jax.nn.gelu(approximate=True): a * (0.5 * (1 + tanh(sqrt(2/pi) * (a + 0.044715 a^3)))),
  // each operation rounded on its own as XLA does (no FMA contraction).
  const float a3 = __fmul_rn(__fmul_rn(a, a), a);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(a, __fmul_rn(0.044715f, a3)));
  return __fmul_rn(a, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

namespace tc {

constexpr int WG = 128;            // threads of a warpgroup
constexpr int BM = 256, BN = 128;  // the default output tile
constexpr int XG = KT / 8;         // 16-byte groups of a full x tile row
constexpr int SM_SMEM = 233472;    // shared memory of an sm_90 SM (1 KB of it kept per block)

// A block owns a (TBM, TBN) output tile: TBM / 64 warpgroups, warpgroup w
// owning rows 64 w.., each issuing wgmma.m64n{TBN}k16. Shared memory: two
// stages of the x tile (TBM x KT) and the decoded W tile (KT x TBN), bf16,
// plus two mbarriers (16 bytes): 192 KB at the default tile, 128 KB at
// 128 x 128, 160 KB at 256 x 64, 96 KB at 128 x 64, which alone leaves room
// for two blocks an SM (MINB, the __launch_bounds__ minimum).
template <int TBM, int TBN>
struct Tile {
  static_assert((TBM == 128 || TBM == 256) && (TBN == 64 || TBN == 128), "an instantiated tile");
  static constexpr int NT = TBM / 64 * WG;               // threads of a block
  static constexpr int X_BYTES = TBM * KT * 2;           // x tile of a stage
  static constexpr int STAGE = X_BYTES + KT * TBN * 2;   // x and W tiles
  static constexpr size_t SMEM = 2 * (size_t)STAGE;      // two stages
  static constexpr int MINB = 2 * (SMEM + 16 + 1024) <= SM_SMEM ? 2 : 1;
  static_assert(SMEM + 16 <= MAX_SMEM, "shared memory of a block");
};

enum Epilogue { PLAIN = 0, BIAS_GELU = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of an operand in the 128-byte swizzle: start
// address, LBO and SBO (bytes), layout type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Byte offsets in the 128-byte swizzle: 16-byte chunk c of a 128-byte row is
// stored at chunk c ^ (row % 8) of its row, 8 rows to a 1 KB atom (the atoms
// 1 KB aligned). x tile (K-major): row m of k atom k / 64 (64 values a row),
// atoms of 8 rows 1 KB apart, the two k atoms TBM * 128 bytes apart. W tile
// (MN-major): row k of n atom n / 64, rows 128 bytes apart (8-row groups
// 1 KB), the two n atoms 16 KB apart.
template <int TBM>
__device__ __forceinline__ int x_off(int m, int c16) {  // c16: 16-byte chunk of the 128 k
  return (c16 >> 3) * (TBM * 128) + m * 128 + (((c16 & 7) ^ (m & 7)) << 4);
}
__device__ __forceinline__ int w_off(int k, int n) {
  return (n >> 6) * (KT * 128) + k * 128 + ((((n >> 3) & 7) ^ (k & 7)) << 4) + (n & 7) * 2;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) = [d +] a (64 x 16, K-major) * b (16 x 128, MN-major),
// bf16, both in shared memory.
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}


// The same with n 64: d (64 x 64, f32) = [d +] a (64 x 16) * b (16 x 64).
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d [+]= a * b at the tile's n (TBN 64 or 128).
template <int TBN>
__device__ __forceinline__ void mma_n(float (&d)[TBN / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (TBN == 128) mma_n128(d, a, b, accumulate);
  else mma_n64(d, a, b, accumulate);
}

// Value s of a loaded word as the float 2^23 + q (the bits of q under the
// exponent of 2^23): float(q) is this less 2^23, both exact.
template <int BITS>
__device__ __forceinline__ float biased(int word, int hi, int s, int hs) {
  return __int_as_float(0x4B000000 | grid_value<BITS>(word, hi, s, hs));
}

// The packed words of one weight tile with their scales and zeros, loaded
// one step ahead, and their decode into a stage. Item p of a tile is word
// row wr of the column pair (n, n + 1): lanes p & 3 take the four pairs of
// 8 columns, (p >> 2) & 7 eight consecutive word rows, the rest walks
// column groups, then word rows. Where a tile has fewer items than a whole
// number a thread (2- and 3-bit words in a 256 x 64 tile) the last ones
// are idle.
template <int BITS, int TBN, int NT>
struct Weights {
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int TOTAL = (KT / PER) * (TBN / 2);       // items of a tile
  static constexpr int ITEMS = (TOTAL + NT - 1) / NT;        // items a thread
  static_assert((KT / PER) % 8 == 0, "whole groups of 8 word rows");
  int w0[ITEMS], w1[ITEMS], h0[ITEMS], h1[ITEMS];
  float s0[ITEMS], s1[ITEMS], z0[ITEMS], z1[ITEMS];
  int off[ITEMS];  // row0 + i | i << 8 of the item's word row, -1 past the tile's word rows

  __device__ __forceinline__ static void item(int it, int& wr, int& n) {
    const int p = threadIdx.x + it * NT, rest = p >> 5;
    n = (rest % (TBN / 8)) * 8 + (p & 3) * 2;
    wr = (rest / (TBN / 8)) * 8 + ((p >> 2) & 7);
  }

  __device__ __forceinline__ void init(int pb, int kt) {
    const int rpp = pb / PER;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      int wr, n, i, row0;
      item(it, wr, n);
      locate_row(wr, rpp, pb, i, row0);
      const bool live = TOTAL % NT == 0 || threadIdx.x + it * NT < TOTAL;
      off[it] = live && wr < kt / PER ? (row0 + i) | (i << 8) : -1;
    }
  }

  // The words of the tile whose first row is k0, with their scales and
  // zeros (zeros past K and N).
  __device__ __forceinline__ void load(const int32_t* __restrict__ qw,
                                       const int32_t* __restrict__ qw_hi,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ zeros, int k0, int K, int n0,
                                       int N, int pb, int groupsize, int gshift, bool pairs) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      int wr, n;
      item(it, wr, n);
      const int gr = k0 / PER + wr, gn = n0 + n;  // word row: whole blocks, so k0 / PER + wr
      w0[it] = w1[it] = h0[it] = h1[it] = 0;
      s0[it] = s1[it] = z0[it] = z1[it] = 0.f;
      if (off[it] < 0 || gr >= K / PER || gn >= N) continue;
      const long at = (long)gr * N + gn;
      const int i = off[it] >> 8, kb = k0 + (off[it] & 0xff) - i;  // the pack block's first row
      const long gi = (long)(gshift >= 0 ? kb >> gshift : kb / groupsize) * N + gn;
      if (pairs) {  // N even: a pair is one aligned 8-byte load
        const int2 v = __ldg(reinterpret_cast<const int2*>(qw + at));
        const float2 sc = __ldg(reinterpret_cast<const float2*>(scales + gi));
        const float2 zr = __ldg(reinterpret_cast<const float2*>(zeros + gi));
        w0[it] = v.x, w1[it] = v.y, s0[it] = sc.x, s1[it] = sc.y, z0[it] = zr.x, z1[it] = zr.y;
      } else {
        w0[it] = __ldg(qw + at), s0[it] = __ldg(scales + gi), z0[it] = __ldg(zeros + gi);
        if (gn + 1 < N)
          w1[it] = __ldg(qw + at + 1), s1[it] = __ldg(scales + gi + 1), z1[it] = __ldg(zeros + gi + 1);
      }
      if constexpr (BITS == 3) {
        const int half = pb / 32;
        const long ah = (long)(kb / 32 + (i >= half ? i - half : i)) * N + gn;
        h0[it] = __ldg(qw_hi + ah);
        if (gn + 1 < N) h1[it] = __ldg(qw_hi + ah + 1);
      }
    }
  }

  // Decode the loaded tile into the stage's B tile. Plane s of the word row
  // at tile row r is row r + s * rpp; where rpp % 8 == 0 every plane keeps
  // the row's swizzle, so the address steps by rpp rows. Zero points that
  // are whole numbers (every RTN and GPTQ grid) take one subtraction a
  // value: (2^23 + q) - (2^23 + z) is q - z exactly, as float(q) - z is;
  // other zeros take dequant()'s two.
  __device__ __forceinline__ void store(unsigned char* wst, int rpp) const {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      if (off[it] < 0) continue;
      int wr, n;
      item(it, wr, n);
      const int i = off[it] >> 8, r = off[it] & 0xff, hs = BITS == 3 && i >= (rpp >> 1);
      const float sa = s0[it], sb = s1[it], za = z0[it], zb = z1[it];
      unsigned char* dst = wst + w_off(r, n);
      auto at = [&](int s) {
        return rpp % 8 == 0 ? dst + s * rpp * 128 : wst + w_off(r + s * rpp, n);
      };
      if (za == rintf(za) && zb == rintf(zb) && fabsf(za) < 4194304.f && fabsf(zb) < 4194304.f) {
        const float ba = za + 8388608.f, bb = zb + 8388608.f;  // exact
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          const float v0 = __fmul_rn(__fsub_rn(biased<BITS>(w0[it], h0[it], s, hs), ba), sa);
          const float v1 = __fmul_rn(__fsub_rn(biased<BITS>(w1[it], h1[it], s, hs), bb), sb);
          *reinterpret_cast<__nv_bfloat162*>(at(s)) = __floats2bfloat162_rn(v0, v1);
        }
      } else {
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          const float v0 = dequant(grid_value<BITS>(w0[it], h0[it], s, hs), za, sa);
          const float v1 = dequant(grid_value<BITS>(w1[it], h1[it], s, hs), zb, sb);
          *reinterpret_cast<__nv_bfloat162*>(at(s)) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
};

// x tiles of 128 columns by TMA: two boxes of (TBM rows, 64 columns), each
// a k atom of the layout above (the tensor map's 128-byte swizzle is the
// layout's), rows past M and columns past K filled with zeros. One thread
// arms the stage's mbarrier with the tile's bytes and issues both copies.
using samq_tma::mbar_init;
using samq_tma::mbar_wait;
template <int TBM>
__device__ __forceinline__ void tma_x(unsigned char* xst, uint64_t* bar, const CUtensorMap* map,
                                      int k0, int m0) {
  samq_tma::mbar_expect(bar, TBM * KT * 2);
#pragma unroll
  for (int a = 0; a < 2; ++a)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(xst + a * (TBM * 128))),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(k0 + 64 * a), "r"(m0), "r"(smem_u32(bar))
        : "memory");
}

// The x tile copies of one thread: 16-byte chunk c16 = tid % 16 (fixed per
// thread) of rows tid / 16 + STEP it, it < 8 (STEP = 32 at 256 rows, 16 at
// 128); the 16 lanes of a half warp read one 256-byte row of x and write its
// chunks to distinct banks.
template <int TBM, int NT>
struct XCopy {
  static constexpr int COPIES = TBM * XG / NT;  // 8
  static constexpr int STEP = NT / XG;          // rows between copies
  static_assert(STEP % 8 == 0, "copies STEP rows apart share a swizzle row");
  const __nv_bfloat16* src;  // row row0, column c of x
  long step;                 // STEP rows of x
  int c, rows, off;          // the thread's column; its copies inside M; its first byte

  __device__ __forceinline__ XCopy(const __nv_bfloat16* x, int m0, int M, int K) {
    const int tid = threadIdx.x, row0 = tid / XG, c16 = tid % XG;
    c = c16 * 8;
    src = x + (long)(m0 + row0) * K + c;
    step = (long)STEP * K;
    rows = m0 + row0 < M ? min(COPIES, (M - m0 - row0 + STEP - 1) / STEP) : 0;
    off = x_off<TBM>(row0, c16);  // rows STEP apart keep row0 % 8, so copy it is off + it * STEP * 128
  }

  // Copy the tile whose first column is k0 (kt columns) into a stage;
  // zeros outside M and K and from column kt on.
  __device__ __forceinline__ void copy(unsigned char* xst, const __nv_bfloat16* x, int k0, int K,
                                       int kt, bool vec) const {
    const int k = k0 + c, kin = c < kt ? min(8, min(kt - c, K - k)) : 0;  // valid columns
#pragma unroll
    for (int it = 0; it < COPIES; ++it) {
      const __nv_bfloat16* p = src + k0 + it * step;
      unsigned char* d = xst + off + it * STEP * 128;
      const bool in = it < rows && kin > 0;
      if (vec) {  // kin is 0 or 8
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(d)),
                     "l"(in ? p : x), "r"(in ? 16 : 0));
      } else {
        alignas(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = in && e < kin ? p[e] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

// One (TBM, TBN) output tile. `vec`: x rows may be copied 16 bytes at a
// time (vec_ok with the tile's rows); `pairs`: N is even, so a column pair
// is one 8-byte load; `vec_out`: N % 8 == 0, the output rows take 16-byte
// stores. bias: float32 (N,), read by the BIAS_GELU epilogue only.
template <int BITS, int EPI, int TBM, int TBN>
__global__ void __launch_bounds__(Tile<TBM, TBN>::NT, Tile<TBM, TBN>::MINB)
    qmm_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ x,
                  const int32_t* __restrict__ qw, const int32_t* __restrict__ qw_hi,
                  const float* __restrict__ scales, const float* __restrict__ zeros,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int K,
                  int N, int pb, int groupsize, bool tma, bool vec, bool vec_out) {
  using Tl = Tile<TBM, TBN>;
  constexpr int NT = Tl::NT, STAGE = Tl::STAGE, X_BYTES = Tl::X_BYTES;
  constexpr int R = TBN / 2;  // accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  const int kt = tile_rows(pb), tiles = (K + kt - 1) / kt;
  const int gshift = (groupsize & (groupsize - 1)) == 0 ? __ffs(groupsize) - 1 : -1;
  const bool pairs = (N & 1) == 0;
  auto xs = [&](int st) { return smem + st * STAGE; };
  auto ws = [&](int st) { return smem + st * STAGE + X_BYTES; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * STAGE);  // a full barrier per stage

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

  // Rows kt..KT-1 of the B tiles are never decoded: zeros, once.
  for (int i = tid; i < 2 * (KT - kt) * (TBN / 8); i += NT) {
    const int st = i / ((KT - kt) * (TBN / 8)), j = i % ((KT - kt) * (TBN / 8));
    *reinterpret_cast<uint4*>(ws(st) + w_off(kt + j / (TBN / 8), (j % (TBN / 8)) * 8)) =
        make_uint4(0, 0, 0, 0);
  }

  Weights<BITS, TBN, NT> w;
  w.init(pb, kt);
  const XCopy<TBM, NT> xc(x, m0, M, K);
  auto copy_x = [&](int t) {  // x of tile t into stage t % 2
    if (!tma) xc.copy(xs(t & 1), x, t * kt, K, kt, vec);
    else if (tid == 0) tma_x<TBM>(xs(t & 1), bars + (t & 1), &xmap, t * kt, m0);
  };
  if (tma && tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  copy_x(0);
  const int rpp = pb / Weights<BITS, TBN, NT>::PER;
  auto load = [&](int t) {
    w.load(qw, qw_hi, scales, zeros, t * kt, K, n0, N, pb, groupsize, gshift, pairs);
  };
  load(0);
  w.store(ws(0), rpp);
  if (tiles > 1) load(1);

  const uint32_t a_off = wg * 64 * 128;  // this warpgroup's 64 rows
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    // Tile t's x and weights are in place and visible to the tensor cores
    // (async proxy); every warpgroup is done with tile t - 1's stage.
    if (tma) mbar_wait(bars + cur, (t >> 1) & 1);
    else asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t xa = smem_u32(xs(cur)) + a_off, wb = smem_u32(ws(cur));
    // Tile t + 1's x copy starts, then the chain of KT / 16 products on
    // tile t (a tile of fewer rows multiplies zeros past kt), then tile t +
    // 1's decode and tile t + 2's loads. Step ks of A starts 32 bytes into
    // the row of k atom ks / 4 (the hardware applies the swizzle to the
    // sum); SBO 1 KB between 8-row groups. B: 8-row groups of k 1 KB apart
    // (SBO), the n atoms (two at 128 columns) KT * 128 apart (LBO).
    if (t + 1 < tiles) copy_x(t + 1);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks)
      mma_n<TBN>(acc, desc(xa + (ks >> 2) * (TBM * 128) + (ks & 3) * 32, 16, 1024),
                 desc(wb + ks * 2048, KT * 128, 1024), 1);
    wg_commit();
    if (t + 1 < tiles) w.store(ws(nxt), rpp);
    if (t + 2 < tiles) load(t + 2);
    wg_wait_all();
    fence_regs(acc);
  }

  // Epilogue: acc[i] is row (warp % 4) * 16 + lane / 4 + 8 ((i >> 1) & 1) of
  // the warpgroup's 64, column 8 (i >> 2) + 2 (lane % 4) + (i & 1). The bf16
  // tile is staged in the ring (row pitch TBN + 8 values, 4 banks apart) and
  // written out in 16-byte rows.
  constexpr int LD = TBN + 8;
  __syncthreads();  // every warpgroup is done with the ring
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < TBN / 8; ++j) {
    const int c = 8 * j + cq;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (EPI == BIAS_GELU) {
      if (n0 + c < N) b0 = __ldg(bias + n0 + c);
      if (n0 + c + 1 < N) b1 = __ldg(bias + n0 + c + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (EPI == BIAS_GELU) {
        v0 = gelu_tanh(__fadd_rn(v0, b0));
        v1 = gelu_tanh(__fadd_rn(v1, b1));
      }
      *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8 * h) * LD + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();
  for (int i = tid; i < TBM * (TBN / 8); i += NT) {
    const int r = i / (TBN / 8), c = (i % (TBN / 8)) * 8, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const __nv_bfloat16* src = stage + r * LD + c;
    __nv_bfloat16* dst = out + (long)m * N + n;
    if (vec_out && n + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

using samq_tma::encode_fn;

// Launch the body with a (TBM, TBN) tile on x (M, K) bf16 -> out (M, N)
// bf16. x tiles of 128 rows arrive by TMA; other tiles (pack blocks that do
// not divide 128) and x that TMA cannot address (rows not 16-byte
// multiples) by cp.async.
template <int BITS, int EPI, int TBM = BM, int TBN = BN>
inline int run(const __nv_bfloat16* x, const int32_t* qw, const int32_t* qw_hi,
               const float* scales, const float* zeros, const float* bias, __nv_bfloat16* out,
               int M, int K, int N, int pb, int groupsize, cudaStream_t stream) {
  const bool vec = vec_ok(x, K, tile_rows(pb), 8);
  const bool vec_out = N % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if ((N + TBN - 1) / TBN > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  bool tma = vec && tile_rows(pb) == KT;
  if (tma) {
    const auto fn = encode_fn();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {64, TBM}, estr[2] = {1, 1};
    if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(x), dims,
           strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((M + TBM - 1) / TBM, (N + TBN - 1) / TBN);
  return launch(qmm_tc_kernel<BITS, EPI, TBM, TBN>, grid, Tile<TBM, TBN>::NT,
                Tile<TBM, TBN>::SMEM + 16, stream, map, x, qw, qw_hi, scales, zeros, bias, out, M,
                K, N, pb, groupsize, tma, vec, vec_out);
}

}  // namespace tc
}  // namespace samq_quant
