// Tensor-core body of the bfloat16 attention kernels (flash_global.cu,
// flash_windowed.cu), with both products on Hopper's warpgroup MMA
// (wgmma). Their float32 builds run flash_f32.cuh's body on the CUDA cores
// (tensor cores would mean TF32).
//
// Numerics, step for step those of flash_common.cuh:10-21 with T = bf16:
//   qs   = round_bf16(q * (scale * log2 e)),  rel' = round_bf16(rel * log2 e)
//   s    = f32 sum_d qs k  +  (rel_w'[m, n % kw] + rel_h'[m, n // kw])
//   p    = exp2(clip(s, -60, 64) - 64);  sum p over the unrounded f32 p
//   o    = f32 sum_n round_bf16(p) v;    out = round_bf16(o * (1 / sum p))
//   or   clip(rint(o * (r * ois)), +-127) for the int8 epilogue.
// Only the summation order inside the two products differs. One exact
// rescaling: every p is carried times 2^64 (p' = exp2(clip(s) - 64) * 2^64,
// in [2^-60, 2^64]), so that a product p'v at the clamp floor stays a normal
// float on the tensor cores instead of the subnormal 2^-124 v. A power of two
// commutes with bf16 rounding, with the f32 sums and with 1/sum, so o' / sum
// p' = o / sum p. The int8 factor is formed as the plain version forms it,
// r * ois with r = 1 / sum p, and only then scaled by 2^-64: where r * ois
// overflows to inf (every logit of a row below the floor, a large ois), both
// saturate at +-127.
//
// Layout. A block is two warpgroups; each owns 64 query rows (BQ = 128 a
// block) of one (problem, head) and walks the L keys in tiles of BK = 64.
// - q.k: wgmma.m64n64k16, A = the block's qs tile and B = the K tile, both
//   in shared memory, K-major; HDP / 16 depth steps, where HDP is hd rounded
//   up to 16 (5 at hd 80). qs is scaled, rounded and stored once per block.
//   A last tile of at most 16 keys (L 196 = 3 * 64 + 4 leaves 4) runs
//   m64n16k16 and one p.v step.
// - Bias, clamp, exp2 (one ex2.approx: exp2f's result on [-124, 0]) and the
//   row sums run on the f32 accumulator registers; p' is rounded to bf16 and
//   packed straight into the register A operand of p.v (the m64nNk16
//   accumulator layout of 16 keys is the A fragment layout of one k16 step).
// - p.v: wgmma.m64n16k16, HDP / 16 column chunks per 16-key step, B = the V
//   tile, MN-major (transposed): V rows are keys with hd contiguous.
// - K and V tiles arrive by cp.async (16 bytes a copy, zero-filled past L
//   and past hd) into a ring of two stages: the copy of tile t + 1 runs
//   under the products of tile t. hd 80 is 160 bytes a row, not a power of
//   two, so the tiles use the non-swizzled core-matrix layout: a core
//   matrix is 8 keys x 16 bytes, stored as 128 contiguous bytes, (key group,
//   16-byte column group) at ((kg * HDP / 8 + dg) * 128). The device-memory
//   operands are not padded; columns hd..HDP-1 are zeros in shared memory.
// - Keys n >= L get p = 0 (not the floor's 2^-124) and add nothing to sum p.
// - rel_h' and rel_w' of the block's rows sit in shared memory as bf16 (the
//   rounded values are bf16 numbers). With kw == BK (the ViT global grid,
//   64 x 64) n // kw is the tile index and n % kw the column, so rel_w is
//   read as column pairs and rel_h once a tile; otherwise a table of
//   (n // kw, n % kw) for the 64 keys of a tile, built in its stage of the
//   ring with the tile's copy, gives them (shared memory does not grow with
//   L). At ViT-H's global shape the table alone makes flash_global 1.9x
//   slower (tools/attention_timing.py), so the kw == BK path stays.
#pragma once

#include <type_traits>

#include "flash_common.cuh"

namespace samq {
namespace tc {

constexpr int WG = 128;            // threads of a warpgroup
constexpr int BQ = 128;            // query rows a block: two warpgroups of 64
constexpr int BK = 64;             // keys a tile
constexpr float P_SCALE = 0x1p64f;  // p is carried times 2^64 (see above)
constexpr int STAGES = 2;          // K/V stages of the ring

constexpr int NTHREADS = 2 * WG;   // threads a block

// Dynamic shared memory of a block: the stages of K and V tiles, the qs
// tile, the bf16 rel tiles of its rows, and a 64-entry key index table per
// stage (512 bytes, unread on the kw == BK path).
inline size_t smem_bytes(int hdp, int kh, int kw) {
  size_t b = (2 * STAGES * (size_t)BK + BQ) * hdp * 2 + (size_t)BQ * (kh + kw) * 2;
  b = (b + 15) & ~(size_t)15;
  return b + (size_t)STAGES * BK * 4;
}

// 2^x for x in [-126, 0]: exp2f's own result there (exp2f adds a rescaling
// only for x < -126), in one instruction.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// round_bf16(rel * log2 e) of rows m0 .. m0 + BQ - 1 of a span of rows of
// `width` values each, contiguous in device memory; zeros past row L.
__device__ __forceinline__ void load_rel(__nv_bfloat16* dst, const __nv_bfloat16* src, int width,
                                         int m0, int L) {
  const int n = BQ * width, valid = (L - m0) * width;
  src += (long)m0 * width;
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += NTHREADS)
    dst[i] = __float2bfloat16(i < valid ? __bfloat162float(src[i]) * LOG2E_F : 0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a non-swizzled operand: start address, LBO (the
// byte stride between core matrices along K) and SBO (along M or N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments in registers: they stay live, and unchanged,
// until the wait after the products that read them.
template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int f = 0; f < 4; ++f) asm volatile("" : "+r"(r[i][f])::"memory");
}

// d (64 x 64, f32) = [d +] a (64 x 16) * b (16 x 64), bf16, both K-major in
// shared memory.
__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same for 16 keys: d (64 x 16, f32).
__device__ __forceinline__ void mma_qk(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16, f32) += a (64 x 16, bf16 registers) * b (16 x 16, MN-major).
__device__ __forceinline__ void mma_pv(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// One (problem, head), query rows m0 .. m0 + BQ - 1. `vec`: q, k and v rows
// may be read 16 bytes at a time (hd % 8 == 0, 16-byte aligned rows).
// NARROW: a last tile of at most 16 keys runs a 16-key body (the windowed
// kernel; the global one, whose L is a multiple of 64 at the ViT grids,
// keeps a single body).
template <int HDP, bool NARROW, typename OutT>
__device__ __forceinline__ void attend_rows_tc(const Problem<__nv_bfloat16>& P, int m0, OutT* out,
                                               long out_stride, float ois, bool vec) {
  using bf16 = __nv_bfloat16;
  constexpr int NDG = HDP / 8;      // 16-byte column groups of a K / V row
  constexpr int KS = HDP / 16;      // q.k depth steps; also p.v column chunks
  constexpr int TILE = BK * HDP;    // elements of one K or V tile
  constexpr int CHUNKS = BK * NDG;  // 16-byte copies of one tile
  static_assert(HDP % 16 == 0 && HDP <= MAX_HD, "HDP: a multiple of 16 up to MAX_HD");
  static_assert(2 * CHUNKS % NTHREADS == 0, "whole copies per thread");
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int L = P.L, hd = P.hd, kh = P.kh, kw = P.kw;
  bf16* KV = reinterpret_cast<bf16*>(tc_smem);  // [stage][K, V][TILE]
  bf16* Qs = KV + 2 * STAGES * TILE;            // BQ x HDP, the core-matrix layout
  bf16* Rbuf = Qs + BQ * HDP;                   // BQ x (kh + kw): the rel rows
  int* idx = reinterpret_cast<int*>(  // [stage][BK]: (n // kw) | (n % kw) << 16
      tc_smem + (((size_t)(2 * STAGES * TILE + BQ * HDP + BQ * (kh + kw)) * 2 + 15) & ~(size_t)15));

  const int tid = threadIdx.x, lane = tid & 31;
  const int lr0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // rows lr0, lr0 + 8
  const int cq = 2 * (lane & 3);  // first column of each of the thread's pairs
  const int tiles = (L + BK - 1) / BK;

  // The rel rows: windowed rel_h | rel_w share rows of kh + kw values (one
  // span); global rel_h and rel_w are two arrays of rows of kh and kw.
  const bf16 *Rh, *Rw;
  int ldh, ldw;
  const bool joint =
      P.rel_w == P.rel_h + kh && P.rel_h_stride == kh + kw && P.rel_w_stride == kh + kw;
  // kw == BK with rel_w rows of their own (the global grid): n // kw is the
  // tile and n % kw the column, read as aligned pairs.
  const bool kw64 = kw == BK && !joint;
  if (joint) {
    load_rel(Rbuf, P.rel_h, kh + kw, m0, L);
    Rh = Rbuf, Rw = Rbuf + kh, ldh = ldw = kh + kw;
  } else {  // rel_h_stride == kh, rel_w_stride == kw (the C entry points' layouts)
    load_rel(Rbuf, P.rel_h, kh, m0, L);
    load_rel(Rbuf + BQ * kh, P.rel_w, kw, m0, L);
    Rh = Rbuf, Rw = Rbuf + BQ * kh, ldh = kh, ldw = kw;
  }
  const bf16 *rh0 = Rh + lr0 * ldh, *rh1 = rh0 + 8 * ldh;
  const bf16 *rw0 = Rw + lr0 * ldw, *rw1 = rw0 + 8 * ldw;

  // qs = round_bf16(q * q_scale) in the layout of the K tiles below (16-byte
  // copy c: column group dg of row (c >> 3) / NDG * 8 + (c & 7)); the first
  // barrier of the key loop publishes it.
#pragma unroll
  for (int it = 0; it < BQ * NDG / NTHREADS; ++it) {
    const int c = tid + it * NTHREADS, rest = c >> 3, col = (rest % NDG) * 8;
    const int m = m0 + (rest / NDG) * 8 + (c & 7);
    const bf16* src = P.q + (long)m * P.q_stride + col;
    alignas(16) bf16 raw[8];
    if (vec) {
      *reinterpret_cast<uint4*>(raw) =
          m < L && col < hd ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) raw[e] = m < L && col + e < hd ? src[e] : __float2bfloat16(0.f);
    }
    alignas(16) __nv_bfloat162 qs[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qs[e] = __floats2bfloat162_rn(__bfloat162float(raw[2 * e]) * P.q_scale,
                                    __bfloat162float(raw[2 * e + 1]) * P.q_scale);
    *reinterpret_cast<uint4*>(Qs + c * 8) = *reinterpret_cast<const uint4*>(qs);
  }
  const uint32_t qaddr = smem_u32(Qs) + (tid >> 7) * 8 * NDG * 128;  // this warpgroup's rows

  // Copy the K and V tiles of keys t * BK ... into stage `st`. Copy c of a
  // tile is 16-byte column group dg of key kg * 8 + r8, and lands at byte
  // c * 16: the core-matrix layout above, with no bank conflict on the writes.
  // The stage's index table is written beside it (zeros for absent keys),
  // published by the same barrier.
  auto load_tile = [&](int t, int st) {
    if (!kw64 && tid < BK) {
      const int n = t * BK + tid, hq = n / kw;
      idx[st * BK + tid] = n < L ? hq | ((n - hq * kw) << 16) : 0;
    }
    bf16* dst0 = KV + 2 * st * TILE;
#pragma unroll
    for (int it = 0; it < 2 * CHUNKS / NTHREADS; ++it) {
      const int c = tid + it * NTHREADS, isv = c >= CHUNKS, cc = c - isv * CHUNKS;
      const int rest = cc >> 3, dg = rest % NDG;
      const int n = t * BK + (rest / NDG) * 8 + (cc & 7), col = dg * 8;
      const bf16* src = (isv ? P.v : P.k) + (long)n * P.kv_stride + col;
      bf16* dst = dst0 + isv * TILE + cc * 8;
      if (vec) {
        const bool in = n < L && col < hd;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                     "l"(in ? src : P.k), "r"(in ? 16 : 0));
      } else {
        alignas(16) bf16 vals[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vals[e] = n < L && col + e < hd ? src[e] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float o[KS][8];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[j][e] = 0.f;
  float ls0 = 0.f, ls1 = 0.f;  // this thread's part of sum p' of rows lr0, lr0 + 8
  load_tile(0, 0);
  for (int t = 0; t < tiles; ++t) {
    // Tile t is in place and visible to the tensor cores (async proxy), and
    // every warpgroup is done with tile t - 1, whose stage the next copy takes.
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + 1 < tiles) load_tile(t + 1, (t + 1) % STAGES);
    const uint32_t kaddr = smem_u32(KV + 2 * (t % STAGES) * TILE), vaddr = kaddr + TILE * 2;
    const int n0 = t * BK;

    // The first NK keys of the tile (64, or 16 when the last tile holds no
    // more): q.k, then bias, clamp, exp2 and the row sums on the
    // accumulators, round_bf16(p') packed as the A fragments of p.v, p.v.
    // sp[4j + e]: row lr0 (e < 2) or lr0 + 8, key n0 + 8j + cq + (e & 1).
    auto tile = [&](auto nk) {
      constexpr int NK = decltype(nk)::value;
      float sp[NK / 2];
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) sp[i] = 0.f;
      fence_regs(sp);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_qk(sp, desc(qaddr + ks * 256, 128, NDG * 128),
               desc(kaddr + ks * 256, 128, NDG * 128), ks);
      wg_commit();
      wg_wait_all();
      fence_regs(sp);

      if (NK == BK && kw64) {  // (kw64: L is a multiple of BK, every tile is whole)
        const float h0 = __bfloat162float(rh0[t]), h1 = __bfloat162float(rh1[t]);
#pragma unroll
        for (int j = 0; j < NK / 8; ++j) {
          const float2 w0 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rw0 + 8 * j + cq));
          const float2 w1 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rw1 + 8 * j + cq));
          sp[4 * j + 0] += w0.x + h0;
          sp[4 * j + 1] += w0.y + h0;
          sp[4 * j + 2] += w1.x + h1;
          sp[4 * j + 3] += w1.y + h1;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NK / 8; ++j) {
          const int2 id = *reinterpret_cast<const int2*>(idx + (t % STAGES) * BK + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int hq = (e ? id.y : id.x) & 0xffff, wq = (e ? id.y : id.x) >> 16;
            sp[4 * j + e] += __bfloat162float(rw0[wq]) + __bfloat162float(rh0[hq]);
            sp[4 * j + 2 + e] += __bfloat162float(rw1[wq]) + __bfloat162float(rh1[hq]);
          }
        }
      }
      const bool tail = n0 + NK > L;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fminf(fmaxf(sp[4 * j + e], CLAMP_FLOOR), CLAMP_CAP);
          float p = ex2(x - CLAMP_CAP) * P_SCALE;
          if (tail && n0 + 8 * j + cq + (e & 1) >= L) p = 0.f;
          if (e < 2) ls0 += p; else ls1 += p;
          sp[4 * j + e] = p;
        }
      uint32_t pa[NK / 16][4];
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          pa[kk][f] = pack_bf16(sp[8 * kk + 2 * f], sp[8 * kk + 2 * f + 1]);

#pragma unroll
      for (int j = 0; j < KS; ++j) fence_regs(o[j]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < KS; ++j)
          mma_pv(o[j], pa[kk], desc(vaddr + (2 * kk * NDG + 2 * j) * 128, NDG * 128, 128));
      wg_commit();
      wg_wait_all();
      fence_u32(pa);
#pragma unroll
      for (int j = 0; j < KS; ++j) fence_regs(o[j]);
    };
    if (NARROW && L - n0 <= 16)
      tile(std::integral_constant<int, 16>{});
    else
      tile(std::integral_constant<int, BK>{});
  }

  // A row's sum is spread over the four lanes of a quad.
  ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
  ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
  ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
  ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
  // Per row, the factor of the output: 1 / sum p' for bf16 out, and for
  // int8 out (r * ois) * 2^-64 with r = 1 / (sum p' * 2^-64) = 1 / sum p,
  // the plain version's r * ois to the bit, including its overflow to inf
  // when a row's logits all lie below the floor and ois is large.
  auto factor = [&](float ls) {
    if constexpr (std::is_same<OutT, int8_t>::value)
      return (1.f / (ls * (1.f / P_SCALE)) * ois) * (1.f / P_SCALE);
    else
      return 1.f / ls;
  };
  const float r0 = factor(ls0), r1 = factor(ls1);
  // o[j][4h + e]: row lr0 (e < 2) or lr0 + 8, column 16j + 8h + cq + (e & 1).
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int m = m0 + lr0 + ((e & 2) ? 8 : 0), c = 16 * j + 8 * (e >> 2) + cq + (e & 1);
      if (m < L && c < hd)
        store_out<OutT>(out + (long)m * out_stride + c, o[j][e], (e & 2) ? r1 : r0, 1.f);
    }
}

// f(std::integral_constant<int, HDP>{}) with hd rounded up to a multiple of 16.
template <typename F>
inline int dispatch_hdp(int hd, F&& f) {
  switch ((hd + 15) / 16) {
    case 1: return f(std::integral_constant<int, 16>{});
    case 2: return f(std::integral_constant<int, 32>{});
    case 3: return f(std::integral_constant<int, 48>{});
    case 4: return f(std::integral_constant<int, 64>{});
    case 5: return f(std::integral_constant<int, 80>{});
    case 6: return f(std::integral_constant<int, 96>{});
    case 7: return f(std::integral_constant<int, 112>{});
    case 8: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Two blocks an SM (16 warps to hide the product and barrier waits) where
// the accumulators fit in 128 registers, HDP <= 80.
template <int HDP>
constexpr int min_blocks() {
  return HDP <= 80 ? 2 : 1;
}

}  // namespace tc
}  // namespace samq
