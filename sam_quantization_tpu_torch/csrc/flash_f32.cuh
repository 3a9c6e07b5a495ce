// Register-tiled float32 body of the attention kernels: the float32 builds
// of flash_windowed.cu, flash_global.cu and flash_attn.cu (flash_whole,
// flash_rowblock) all run it. Both products run on the CUDA cores in
// float32 (FFMA): tensor cores would mean TF32, which neither the
// evaluation path's parity nor the trainer's gradient check takes.
//
// Numerics: flash_common.cuh:10-21 with T = float, step for step:
//   qs = q * (scale * log2 e),  rel' = rel * log2 e
//   s  = qs.k + (rel_w'[m, n % kw] + rel_h'[m, n // kw])
//   p  = exp2(clip(s, -60, 64) - 64);  out = (sum_n p v) * (1 / sum_n p)
// or, with OutT = int8_t, out = clip(rint((sum_n p v) * (r * ois)), +-127)
// (store_out<int8_t>). Only the order of the float32 sums differs from the
// plain versions.
//
// What bounds it on an H100: operations. At ViT-H's windowed shape (25
// windows x 16 heads, L 196, hd 80) the products are 4.9 GFLOP, 73 us at
// the 67 TFLOP/s float32 peak, against about 55 MB (16 us); at the global
// shape (16 heads, L 4096) 85.9 GFLOP, 1.28 ms, against about 29 MB.
//
// What held the first float32 body (attend_rows, once in flash_common.cuh)
// back, and what this body does instead:
// - Shared-memory loads bounded its products: a scalar load for every two
//   FMAs from rows of odd pitch. Here a block of 256 threads holds 64 query
//   rows against 64-key tiles; a thread keeps 4 rows x 4 keys of s and 4
//   rows x HDP / 16 columns of the output in registers. q and K rows sit at
//   a pitch of HDP + 4 floats, so one 128-bit load along d serves four
//   depth steps of a row or a key, and the 8 keys a quarter warp reads hit
//   8 distinct bank groups (8 loads for 64 FMAs). p.v reads p four keys a
//   load and each V row 128 bits a thread (4 columns of each 64, then
//   HDP % 64 / 16 more).
// - Warps an SM matter more than the tile: 8 x 8 logits a thread at 128
//   threads a block ran no faster than 4 x 4 at 256 (PERF.md). So a block
//   is held to 128 registers a thread and to half the SM's shared memory,
//   two blocks an SM: p takes the K region of its tile's stage once q.k has
//   read it (a third barrier a tile).
// - K and V went through registers with an integer division a value and
//   three block barriers a tile. Here they come by cp.async into a
//   two-stage ring, zero-filled past L and past hd: tile t + 1 lands while
//   tile t is multiplied. Rows are read in place through a base and a row
//   stride (Problem<float>), so flash_windowed takes a head's q, k and v
//   straight from the (NW, L, 3C) qkv rows. Where hd % 4 == 0 and the bases
//   are 16-byte aligned (`vec`) a copy moves 16 bytes; any other shape
//   takes 4-byte copies in the same kernel.
// - At L 196 the 64 x 64 tiles computed 256 x 256 logits for 196 x 196.
//   Here the row and key groups of 16 that hold no real row or key are
//   skipped in q.k, and p.v stops at the last real key (rounded up to 4),
//   so a block of the last 4 rows or a tile of the last 4 keys costs about
//   a quarter of a whole one. The variants are compile-time (IN, JN).
// - The bias, by BIAS:
//   - BIAS_ROWS: the block's rel_h' and rel_w' rows sit in shared memory
//     (64 x (kh + kw) floats); a thread forms n // kw and n % kw of its
//     keys once a tile. 7 KB at the windowed 14 + 14.
//   - BIAS_REGS, where kw divides 64 (every SAM global grid at 1024 px has
//     kw 64): a key's n % kw is the same in every 64-key tile, so each
//     thread holds its 4 rows x 4 keys of rel_w' in registers for the whole
//     key loop, and a tile's rel_h' slice (64 / kw values a row, one at kw
//     64) lands in the ring beside K and V. Rows of 64 + 64 rel values in
//     shared memory (32 KB) would leave room for one stage only at two
//     blocks an SM; at hd 80 this takes 107,520 bytes, two stages.
//   A shape whose rel rows or HDP leave no room for two stages at two
//   blocks an SM takes one stage, or one block an SM (ring_stages).
// p goes through shared memory (each thread's p.v needs every key of its
// rows).
#pragma once

#include <initializer_list>
#include <type_traits>

#include "flash_tc.cuh"  // flash_common.cuh, tc::smem_u32, tc::dispatch_hdp

namespace samq {
namespace f32t {

constexpr int BQ = 64;         // query rows a block
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;   // 16 x 16: ty the row group, tx the key (and column) group
constexpr int PP = BK + 16;    // p's row pitch (floats): the two row groups of a warp apart
constexpr size_t SM_SMEM = 233472;  // shared memory of an sm_90 SM, 1 KB of it a block's own

enum Bias { BIAS_NONE = 0, BIAS_ROWS = 1, BIAS_REGS = 2 };

__host__ __device__ constexpr int qpitch(int hdp) { return hdp + 4; }
// Floats of a stage's K region, which holds the K tile and then the tile's p.
__host__ __device__ constexpr int kregion(int hdp) {
  return BK * qpitch(hdp) > BQ * PP ? BK * qpitch(hdp) : BQ * PP;
}

// Dynamic shared memory: q, `stages` K regions and V tiles, and the bias
// (BIAS_ROWS: the block's rel rows; BIAS_REGS: a rel_h' slice a stage).
inline size_t smem_bytes(int hdp, int bias, int kh, int kw, int stages) {
  size_t floats = (size_t)BQ * qpitch(hdp) + stages * ((size_t)kregion(hdp) + (size_t)BK * hdp);
  if (bias == BIAS_ROWS) floats += (size_t)BQ * (kh + kw);
  if (bias == BIAS_REGS) floats += (size_t)stages * BQ * (BK / kw);
  return 4 * floats;
}

// The ring's stages: two where two blocks an SM still fit (each block's own
// 1 KB counted), else one where that fits, else the most that one block an
// SM takes (2 or 1); 0 for a shape with no room for one. A kernel held to
// one block an SM (`blocks` 1) takes the last.
inline int ring_stages(int hdp, int bias, int kh, int kw, int blocks) {
  for (size_t limit : {SM_SMEM / 2 - 1024, (size_t)MAX_SMEM})
    for (int st : {2, 1})
      if ((blocks == 2 || limit == (size_t)MAX_SMEM) && smem_bytes(hdp, bias, kh, kw, st) <= limit)
        return st;
  return 0;
}

// Register policy. Every instantiation must fit 128 registers a thread
// (two blocks an SM) with no spill; what fits was read from ptxas's
// reports (CUDA 12.8, sm_90a), and chip_smoke.py checks it on every build.
// - q.k's depth loop unrolled twice holds the next step's operand loads
//   live: flash_windowed and flash_global unroll it once (at ViT-H no
//   slower, and flash_global faster than its unrolled build, which
//   spilled); flash_attn keeps two at HDP <= 80, where its float32 rows
//   read slower unrolled once, and one above, where two spilled.
// - BIAS_REGS's 16 registers of rel_w' still spill at HDP 32, 64 and 96:
//   there the rel rows take shared memory instead. HDP 112 spills with
//   either bias, so flash_global holds it to one block an SM.
__host__ __device__ constexpr int qk_unroll(bool head_split, int hdp) {
  return head_split && hdp <= 80 ? 2 : 1;
}
__host__ __device__ constexpr bool regs_bias_fits(int hdp) {
  return hdp != 32 && hdp != 64 && hdp != 96;
}
__host__ __device__ constexpr int global_blocks(int hdp) { return hdp == 112 ? 1 : 2; }

// The bias a kernel with a rel grid takes at HDP: rel_w' in registers where
// kw divides 64 and they fit, else the rel rows in shared memory.
inline int bias_for(int hdp, int kw) {
  return kw >= 1 && 64 % kw == 0 && regs_bias_fits(hdp) ? BIAS_REGS : BIAS_ROWS;
}

// 16 or 4 bytes from global to shared memory, zeros where !valid.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(tc::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(tc::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// s[i][j] = q row (ty + 16 i) . K row (tx + 16 j) over HDP, for the IN row
// groups and JN key groups in use; d in steps of four, one 128-bit load of
// each operand a step, the depth loop unrolled U times.
template <int HDP, int IN, int JN, int U>
__device__ __forceinline__ void qk(float (&s)[4][4], const float* Qs, const float* Kd, int ty,
                                   int tx) {
  constexpr int QP = qpitch(HDP);
#pragma unroll
  for (int i = 0; i < IN; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll (U)
  for (int d = 0; d < HDP; d += 4) {
    float4 a[IN], b[JN];
#pragma unroll
    for (int i = 0; i < IN; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QP + d);
#pragma unroll
    for (int j = 0; j < JN; ++j) b[j] = *reinterpret_cast<const float4*>(Kd + (tx + 16 * j) * QP + d);
#pragma unroll
    for (int i = 0; i < IN; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        float x = fmaf(a[i].x, b[j].x, s[i][j]);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        s[i][j] = fmaf(a[i].w, b[j].w, x);
      }
  }
}

// o[i][c] += sum over keys 0 .. nk4 - 1 of p[row][n] V[n][col c], rows ty +
// 16 i for the IN row groups in use; column c of a thread is 64 (c / 4) + 4 tx
// + c % 4 in the 64-column chunks, then 64 N64 + RW tx + (c - 4 N64).
template <int HDP, int IN>
__device__ __forceinline__ void pv(float (&o)[4][4 * (HDP / 64) + HDP % 64 / 16], const float* Ps,
                                   const float* Vd, int nk4, int ty, int tx) {
  constexpr int N64 = HDP / 64, RW = HDP % 64 / 16, TD = 4 * N64 + RW;
  for (int n = 0; n < nk4; n += 4) {
    float4 pr[IN];
#pragma unroll
    for (int i = 0; i < IN; ++i) pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PP + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* vr = Vd + (n + e) * HDP;
      float vv[TD];
#pragma unroll
      for (int c = 0; c < N64; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(vr + 64 * c + 4 * tx);
        vv[4 * c] = x.x;
        vv[4 * c + 1] = x.y;
        vv[4 * c + 2] = x.z;
        vv[4 * c + 3] = x.w;
      }
      if constexpr (RW == 2) {
        const float2 x = *reinterpret_cast<const float2*>(vr + 64 * N64 + 2 * tx);
        vv[4 * N64] = x.x;
        vv[4 * N64 + 1] = x.y;
      } else {
#pragma unroll
        for (int c = 0; c < RW; ++c) vv[4 * N64 + c] = vr[64 * N64 + RW * tx + c];
      }
#pragma unroll
      for (int i = 0; i < IN; ++i) {
        const float p = e == 0 ? pr[i].x : e == 1 ? pr[i].y : e == 2 ? pr[i].z : pr[i].w;
#pragma unroll
        for (int c = 0; c < TD; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
  }
}

// f(std::integral_constant<int, n>) for n in 1..4.
template <typename F>
__device__ __forceinline__ void with_groups(int n, F&& f) {
  switch (n) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    default: f(std::integral_constant<int, 4>{}); break;
  }
}

// Query rows m0 .. m0 + BQ - 1 of one problem against its L keys, into
// out (row stride out_stride). hd <= HDP; `vec`: hd % 4 == 0 and q, k, v
// 16-byte aligned with row strides of whole 16 bytes; `stages` 1 or 2 (the
// dynamic shared memory smem_bytes gives). BIAS_REGS needs kw | 64. QK_U:
// q.k's depth loop unrolled that many times (qk_unroll).
template <int HDP, int BIAS, typename OutT, int QK_U>
__device__ __forceinline__ void attend(const Problem<float>& P, int m0, OutT* __restrict__ out,
                                       long out_stride, float ois, int stages, bool vec) {
  static_assert(HDP % 16 == 0 && HDP <= MAX_HD, "HDP: a multiple of 16 up to MAX_HD");
  constexpr int QP = qpitch(HDP), C4 = HDP / 4, N64 = HDP / 64, RW = HDP % 64 / 16;
  constexpr int TD = 4 * N64 + RW, KR = kregion(HDP);
  extern __shared__ __align__(16) float fsm[];
  const int L = P.L, hd = P.hd, kh = P.kh, kw = P.kw;
  const int rt = BIAS == BIAS_REGS ? BK / kw : 0;  // rel_h' values a row a tile
  const int lg = BIAS == BIAS_REGS ? __ffs(kw) - 1 : 0;  // log2 kw
  float* Qs = fsm;                     // BQ x QP: q * q_scale, zeros past L and hd
  float* Ks = Qs + BQ * QP;            // [stage] KR: BK x QP of K, then BQ x PP of p
  float* Vs = Ks + stages * KR;        // [stage] BK x HDP
  float* Rh = Vs + stages * BK * HDP;  // ROWS: BQ x kh of rel_h'; REGS: [stage] BQ x rt of rel_h
  float* Rw = Rh + BQ * kh;            // ROWS: BQ x kw of rel_w'
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  if (vec) {
    for (int i = tid; i < BQ * C4; i += THREADS) {
      const int r = i / C4, c = i - r * C4, m = m0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < L && 4 * c < hd) {
        x = *reinterpret_cast<const float4*>(P.q + (long)m * P.q_stride + 4 * c);
        x.x *= P.q_scale;
        x.y *= P.q_scale;
        x.z *= P.q_scale;
        x.w *= P.q_scale;
      }
      *reinterpret_cast<float4*>(Qs + r * QP + 4 * c) = x;
    }
  } else {
    for (int i = tid; i < BQ * HDP; i += THREADS) {
      const int r = i / HDP, c = i - r * HDP, m = m0 + r;
      Qs[r * QP + c] = m < L && c < hd ? P.q[(long)m * P.q_stride + c] * P.q_scale : 0.f;
    }
  }
  if constexpr (BIAS == BIAS_ROWS) {
    for (int i = tid; i < BQ * kh; i += THREADS) {
      const int r = i / kh, m = m0 + r;
      Rh[i] = m < L ? P.rel_h[(long)m * P.rel_h_stride + i - r * kh] * LOG2E_F : 0.f;
    }
    for (int i = tid; i < BQ * kw; i += THREADS) {
      const int r = i / kw, m = m0 + r;
      Rw[i] = m < L ? P.rel_w[(long)m * P.rel_w_stride + i - r * kw] * LOG2E_F : 0.f;
    }
  }
  // BIAS_REGS: rel_w' of this thread's rows and keys, the same in every tile.
  float rwr[4][4];
  if constexpr (BIAS == BIAS_REGS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rwr[i][j] = m < L ? P.rel_w[(long)m * P.rel_w_stride + ((tx + 16 * j) & (kw - 1))] * LOG2E_F
                          : 0.f;
    }
  }

  // K and V of tile t (and with BIAS_REGS its rel_h slice) into stage st,
  // committed as one group.
  auto load_tile = [&](int t, int st) {
    float* Kd = Ks + st * KR;
    float* Vd = Vs + st * BK * HDP;
    if (vec) {
      for (int i = tid; i < BK * C4; i += THREADS) {
        const int r = i / C4, c = i - r * C4, n = t * BK + r;
        const bool ok = n < L && 4 * c < hd;
        const long src = ok ? (long)n * P.kv_stride + 4 * c : 0;
        cp16(Kd + r * QP + 4 * c, P.k + src, ok);
        cp16(Vd + r * HDP + 4 * c, P.v + src, ok);
      }
    } else {
      for (int i = tid; i < BK * HDP; i += THREADS) {
        const int r = i / HDP, c = i - r * HDP, n = t * BK + r;
        const bool ok = n < L && c < hd;
        const long src = ok ? (long)n * P.kv_stride + c : 0;
        cp4(Kd + r * QP + c, P.k + src, ok);
        cp4(Vd + r * HDP + c, P.v + src, ok);
      }
    }
    if constexpr (BIAS == BIAS_REGS) {
      float* Rd = Rh + st * BQ * rt;
      for (int i = tid; i < BQ * rt; i += THREADS) {
        const int r = i / rt, hq = t * rt + i - r * rt, m = m0 + r;
        const bool ok = m < L && hq < kh;
        cp4(Rd + i, P.rel_h + (ok ? (long)m * P.rel_h_stride + hq : 0), ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int tiles = (L + BK - 1) / BK;
  const int in = (min(BQ, L - m0) + 15) / 16;  // row groups holding real rows
  float o[4][TD], lsum[4] = {0.f, 0.f, 0.f, 0.f}, s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TD; ++c) o[i][c] = 0.f;

  if (stages == 2) load_tile(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int st = stages == 2 ? t & 1 : 0;
    if (stages == 1) {
      if (t > 0) __syncthreads();  // the previous tile's p.v is done
      load_tile(t, 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // tile t landed for all; stage (t + 1) & 1 is free
    if (stages == 2 && t + 1 < tiles) load_tile(t + 1, (t + 1) & 1);
    float* Kd = Ks + st * KR;
    const int n0 = t * BK, nk = min(BK, L - n0), jn = (nk + 15) / 16;
    with_groups(in, [&](auto I) {
      with_groups(jn, [&](auto J) {
        qk<HDP, decltype(I)::value, decltype(J)::value, QK_U>(s, Qs, Kd, ty, tx);
      });
    });
    __syncthreads();  // the K tile is read: its region takes p
    float* Ps = Kd;
    const float* Rt = Rh + st * BQ * rt;  // BIAS_REGS: this tile's rel_h slice
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= jn) break;
      const int c = tx + 16 * j, n = n0 + c;
      const int hq = BIAS == BIAS_ROWS ? n / kw : 0, wq = n - hq * kw;  // key n's rel columns
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= in) break;
        const int r = ty + 16 * i;
        float p = 0.f;
        if (n < L) {
          float x = s[i][j];
          if constexpr (BIAS == BIAS_ROWS) x += Rw[r * kw + wq] + Rh[r * kh + hq];
          // rel_h' formed here: __fmul_rn keeps the product rounded on its
          // own, as the plain version rounds it, out of an FMA with rel_w'.
          if constexpr (BIAS == BIAS_REGS)
            x += rwr[i][j] + __fmul_rn(Rt[r * rt + (c >> lg)], LOG2E_F);
          x = fminf(fmaxf(x, CLAMP_FLOOR), CLAMP_CAP);
          p = exp2f(x - CLAMP_CAP);
          lsum[i] += p;
        }
        Ps[r * PP + c] = p;
      }
    }
    __syncthreads();  // p of the tile is whole
    with_groups(in, [&](auto I) {
      pv<HDP, decltype(I)::value>(o, Ps, Vs + st * BK * HDP, (nk + 3) & ~3, ty, tx);
    });
  }

  // Row sums: the 16 threads of a row group are the lanes of a half warp.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int sh = 8; sh >= 1; sh >>= 1) lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], sh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= L) continue;
    const float r = 1.f / lsum[i];
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int col = c < 4 * N64 ? 64 * (c / 4) + 4 * tx + c % 4 : 64 * N64 + RW * tx + c - 4 * N64;
      if (col < hd) store_out<OutT>(out + (long)m * out_stride + col, o[i][c], r, ois);
    }
  }
}

// Launch `kernel` (a __global__ function that runs attend) on `grid` with
// the ring stages and shared memory of the shape, passed as its last
// argument after `args`. A shape with no room for one stage is refused.
template <int HDP, int BIAS, int BLOCKS = 2, typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, int kh, int kw, cudaStream_t stream, Args... args) {
  const int stages = ring_stages(HDP, BIAS, kh, kw, BLOCKS);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  return samq::launch(kernel, grid, THREADS, smem_bytes(HDP, BIAS, kh, kw, stages), stream,
                      args..., stages);
}

// 16-byte copies take hd % 4 == 0 and 16-byte aligned bases.
inline bool vec_ok(int hd, std::initializer_list<const void*> bases) {
  if (hd % 4 != 0) return false;
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace f32t
}  // namespace samq
