// Tensor-core body of the attention kernels whose K and V arrive by TMA:
// both products on Hopper's warpgroup MMA (wgmma), built from flash_tc.cuh's
// primitives. Compile-time policy picks the softmax (or none), the bias and
// whether q is scaled; each instantiation computes its plain version's
// function. It replaces
//   P2 _kernel_dots_floor (tools/packed_probe.py:97)        NONE, no bias
//   P3 _kernel_presplit  (tools/packed_probe.py:111)        ROWMAX, no bias
//   P4 _k_pair           (tools/global_stage_probe.py:183)  ROWMAX or CLAMP
//   P5 _k_pair_bias      (tools/global_stage_probe.py:316)  the same, BIAS
// through probe_heads.cu,
//   P1 _kernel_no_softmax (tools/packed_probe.py:71)        AUG
// through probe_packed.cu, and
//   _attn_kernel_rowblock (sam_quantization_tpu/ops/flash_attention.py:680)
//   _attn_kernel          (sam_quantization_tpu/ops/flash_attention.py:213)
//                        FLASH, with or without BIAS (flash_attn.cu's
//                        bfloat16 flash_rowblock and flash_whole)
//
// Numerics, step for step those of the plain versions (ops/probes.py,
// ops/flash_attention.py):
//   s   = f32 sum_d q k, with FLASH q first scaled: qs = round_bf16(q * q_scale)
//   BIAS: s += (rw[m, n % kw] + rh[m, n // kw]), rw + rh formed first, in
//         f32 from bf16 rows: the raw tiles (probes), or round_bf16(rel *
//         log2 e) (FLASH)
//   ROWMAX: p = exp2(s - m), m = max_n s   (exp(s - m) with EXP2 false, as
//                                           ex2((s - m) * log2 e))
//   CLAMP:  p = exp2(min(s, 40) - 40)      (no floor)
//   FLASH:  p = exp2(clip(s, -60, 64) - 64)
//   o   = f32 sum_n round_bf16(p) v;  out = round_bf16(o * (1 / sum_n p))
// with sum p over the unrounded f32 p; and
//   NONE:   p = s (not a probability: any sign and size, no carry below);
//           out = round_bf16(f32 sum_n round_bf16(s) v), no row sum.
//   AUG:    NONE on s = f32 [qs | rel] . [k | rel], qs = round_bf16(q *
//           q_scale): the rel rows (R columns) are R more q.k depth.
// Only the summation order inside the two products and the row sums differs
// (and, for exp, the rounding of its argument times log2 e; for NONE it can
// move a rounded s near a tie by one bf16 step). What keeps it exact where
// the plain version is:
// - The row max is exact: a first pass streams the K tiles through q.k (and
//   the bias) and keeps each row's max of s; the second pass recomputes the
//   same s and takes exp2(s - m) against it, so every p is the plain
//   version's and the row's largest p is 1. This is 1.5x the product work
//   of one pass; an online softmax would round p at a running max instead.
// - IEEE gradual underflow as the plain version has it: the probes' exp2 is
//   the non-ftz ex2.approx.f32, so a clamp-40 logit in (-109, -86) gives the
//   subnormal p that the plain version keeps, and a row whose logits all lie
//   there sums to a finite sum p (FLASH's floor keeps p >= 2^-124, normal,
//   and takes flash_tc.cuh's ftz ex2). For p.v, p is rounded to bf16 first
//   (cvt keeps subnormals) and then carried times 2^64 by a bf16x2 multiply,
//   which is exact, subnormal inputs included; the f32 products on the
//   tensor cores then stay normal. o' = 2^64 o, so out = round_bf16((o' *
//   (1 / sum p)) * 2^-64), the plain version's rounding of o * (1 / sum p).
//   A CLAMP row whose every p underflows to 0 sums to 0 and gives 0 * inf =
//   NaN, as the plain version (and the TPU kernel of _k_pair) does.
// - Keys n >= L take no part: -inf in the max, p = 0 (the port does not pad
//   L). Rows m >= L are computed on zeros and not stored.
//
// What bounds it on an H100: at P4/P5's (16, 4096, 128) the one-pass
// product work is 137 GFLOP, 139 us at 989 TFLOP/s bf16 (operations); the
// row-max mode's second q.k pass makes it 206 GFLOP, 208 us. At flash_rowblock's
// rel-less ViT-H global shape (16, 4096, 80) it is 85.9 GFLOP, 87 us
// (operations). At P2's and P3's (400, 256, 128) the 105 MB of bf16
// traffic take 31 us (bytes), above 13.4 (P3: 20.1) GFLOP; at flash_whole's
// (400, 196, 80) with rel 14 + 14 the 54 MB take 16 us (bytes). Every block
// reads its head's whole K and V (from L2: 32 times at L 4096), so the
// copies have to keep pace with the products, and the bias and softmax
// with both.
//
// Layout. A block is two consumer warpgroups, each 64 query rows of one
// (batch, head) (BQ = 128 rows a block), and one producer warp; keys are
// walked in tiles of BK = 64. HDP is D rounded up to 16 (128 at the probes,
// 80 at ViT-H's head dim, which stays unpadded in device memory).
// - Shared memory holds q, K and V in the 128-byte swizzle: atoms of 64
//   columns (128-byte rows, 16-byte chunk c of row r at c ^ (r % 8)).
// - The producer warp brings q once and the K (and in the second pass V)
//   tile of each step into a ring of four stages by TMA (lane 0, 3D
//   tensor maps that read zeros past L and past D), each stage's full
//   mbarrier counting the bytes. TMA needs rows of whole 16-byte groups and
//   16-byte aligned operands: the wrappers pad D to a multiple of 8 and copy
//   an unaligned operand before the launch. A stage is written again once
//   all 256 consumer threads have arrived on its empty mbarrier. The
//   consumers meet no block barrier, so the two warpgroups drift apart and
//   one's softmax runs beside the other's products.
// - AUG (P1): q, K and V are heads read in place from (NW, L, nh * hd)
//   through 4D tensor maps (probe_packed.cu says why); the rel rows of the
//   block's 128 rows come with q and those of the step's 64 keys with each
//   K tile (the ring's stages grow by one rel tile), and R' / 16 k16 steps
//   of wgmma join the hd steps' chain. The output is at head columns.
// - FLASH: each warpgroup scales its own 64 q rows in shared memory once q
//   has landed (element-wise, so the swizzle does not matter), then fences
//   them to the tensor cores' proxy and meets its 128 threads at a named
//   barrier before its first wgmma. AUG scales q the same way.
// - BIAS: each warpgroup copies the rh and rw rows of its 64 rows into
//   shared memory as bf16 before q.k (128 x (kh + kw) values a block; the
//   ring has two stages where four do not fit beside them, and a shape
//   whose rows leave no room for two is refused). At kw == 64 (the ViT-H
//   grid) n // kw is the tile and n % kw the column: each thread keeps its
//   16 rw pairs packed in registers and reads rh once a tile. At any other
//   kw the producer warp's lanes write the stage's 64-entry (n // kw,
//   n % kw) table before they arrive on its full barrier.
// - q.k: wgmma.m64n64k16, A = the warpgroup's q rows and B = the K tile,
//   both in shared memory, K-major; HDP / 16 depth steps.
// - Bias, max, exp2, masks and row sums on the f32 accumulator registers;
//   the packed bf16 p is the register A operand of p.v (the accumulator
//   layout of 16 keys is the A fragment layout of one k16 step).
// - p.v: wgmma.m64n128k16 at HDP 128, else m64n64k16 per 64 output columns
//   and m64n16k16 for the rest (one of each at HDP 80); B = the V tile,
//   MN-major.
// - The softmax pass (NONE's one pass too) issues q.k of tile t and p.v of
//   tile t - 1 together, waits for both, then forms tile t's p with no
//   product in flight.
// What ptxas needs (-Xptxas -v names each case): the producer/consumer
// split is taken on a warp-uniform value, else it serializes every wgmma
// (C7520); no accumulator is written or read outside its chain while
// another chain is in flight (C7514, C7515), so the row-max pass folds each
// tile before it issues the next; q as a register operand of q.k cost
// registers that ptxas then lacked (C7512). Forming tile t's p while p.v of
// tile t - 1 was still in flight is not safe: ptxas gave the registers of
// p.v's register operand, which the tensor cores read after the issue, to
// the new p and its temporaries (wrong rows on the card once the exp code
// grew), so p.v is waited for first. The bias, q-scale and FLASH policies
// met no new diagnostic; the named barrier with a register id makes ptxas
// reserve all 16 barriers ("used 16 barriers"), harmless at one block an SM.
#pragma once

#include <string.h>

#include "flash_tc.cuh"
#include "tma.cuh"

namespace samq {

enum ProbeMode { PROBE_NONE = 0, PROBE_ROWMAX = 1, PROBE_CLAMP = 2, FLASH_CLIP = 3, PROBE_AUG = 4 };
constexpr float PAIR_CAP = 40.f;  // _k_pair's static shift

namespace ptc {

using tc::BK;
using tc::BQ;
constexpr int MAX_STAGES = 4;           // K/V stages of the ring, at most
constexpr int PROBE_MAX_R = 128;        // AUG's rel columns: two atoms
constexpr int CONSUMERS = 2 * tc::WG;   // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int ATOM_ROW = 128;           // bytes of a row of a 128-byte-swizzle atom: 64 values
constexpr int BAR_BYTES = 80;           // full and empty per stage, q's: 9 mbarriers, 16-aligned

// Shared memory: per stage, the K tile then the V tile, each NA atoms of
// BK rows x 128 bytes (NA = HDP / 64 rounded up: the 64 columns of an atom),
// and with AUG the keys' rel tile, RA atoms of BK rows; then q, NA atoms of
// BQ rows, and with AUG the rows' rel tile, RA atoms of BQ rows; the
// barriers; a 64-entry key index table per stage; and the bias rows, BQ x kh
// then BQ x kw bf16.
__host__ __device__ constexpr int atoms(int hdp) { return (hdp + 63) / 64; }
inline size_t stage_bytes(int hdp, int ra) {
  return (size_t)(2 * atoms(hdp) + ra) * BK * ATOM_ROW;
}
inline size_t fixed_bytes(int hdp, int kh, int kw, int ra) {
  return (size_t)(atoms(hdp) + ra) * BQ * ATOM_ROW + BAR_BYTES + MAX_STAGES * BK * 4 +
         (size_t)BQ * (kh + kw) * 2;
}

// 2^x with gradual underflow: subnormal results for x in (-149, -126).
__device__ __forceinline__ float ex2_sub(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (round_bf16(lo), round_bf16(hi)) * 2^64, packed; exact for every finite
// input, subnormal bf16 values included (bf16 arithmetic keeps subnormals).
__device__ __forceinline__ uint32_t pack_carried(float lo, float hi) {
  uint32_t r = tc::pack_bf16(lo, hi);
  asm("mul.rn.bf16x2 %0, %0, %1;" : "+r"(r) : "r"(0x5F805F80u));  // bf16 2^64, twice
  return r;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// wgmma matrix descriptor of an operand in the 128-byte swizzle (layout
// type 1 in bits 62-63): start address, LBO and SBO in bytes.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return tc::desc(addr, lbo, sbo) | (1ull << 62);
}

using samq_tma::mbar_arrive;
using samq_tma::mbar_expect;
using samq_tma::mbar_init;
using samq_tma::mbar_wait;

// Box (64 columns from col, rows from row, head bh) of a (BH, L, D) tensor
// map into dst, counted on bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int col, int row,
                                        int bh, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bh), "r"(tc::smem_u32(bar))
      : "memory");
}

// Box (64 columns from col, head h, rows from row, window w) of a 4D map of
// heads read in place (AUG) into dst, counted on bar.
__device__ __forceinline__ void tma_box4(void* dst, const CUtensorMap* map, int col, int h,
                                         int row, int w, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(h), "r"(row), "r"(w),
      "r"(tc::smem_u32(bar))
      : "memory");
}

// d (64 x 64, f32) += a (64 x 16, bf16 registers) * b (16 x 64, MN-major).
__device__ __forceinline__ void mma_pv64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// (d0 | d1) (64 x 128, f32: columns 0-63 | 64-127) += a (64 x 16, bf16
// registers) * b (16 x 128, MN-major).
__device__ __forceinline__ void mma_pv128(float (&d0)[32], float (&d1)[32], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]),
        "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]),
        "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]), "+f"(d1[8]), "+f"(d1[9]),
        "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]),
        "+f"(d1[22]), "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

struct Maps {
  CUtensorMap q, k, v, r;  // r: AUG's rel rows, boxes of BK rows
};

// What a launch takes besides the tensor maps: out (D a multiple of 8,
// 4-byte aligned), written a pair of columns at a time; with BIAS the rows
// rh (BH, L, kh) and rw (BH, L, kw), kh * kw == L; the ring's stage count;
// the q scale of FLASH and AUG; and AUG's heads a window (out is (NW, L,
// nh * D), blockIdx.y = w * nh + h), rel atoms and rel depth steps.
struct Args {
  __nv_bfloat16* out;
  const __nv_bfloat16* rh;
  const __nv_bfloat16* rw;
  int L, D, kh, kw, stages;
  float q_scale;
  int nh, ra, rs;
};

// One (batch, head) of (BH, L, D) operands a blockIdx.y, rows blockIdx.x *
// BQ..; q, K and V arrive by TMA through `maps`.
template <int MODE, bool EXP2, bool BIAS, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    probe_tc_kernel(const __grid_constant__ Maps maps, const Args args) {
  using bf16 = __nv_bfloat16;
  constexpr bool ROWMAX = MODE == PROBE_ROWMAX, FLASH = MODE == FLASH_CLIP, NONE = MODE == PROBE_NONE;
  constexpr bool AUG = MODE == PROBE_AUG;  // P1: NONE's pass on heads in place, rel on both sides
  constexpr bool DOTS = NONE || AUG;       // no softmax: p = s, no carry, no row sum
  constexpr int NA = atoms(HDP);    // 64-column atoms of a row
  constexpr int KS = HDP / 16;      // q.k depth steps
  constexpr int TILE = NA * BK * ATOM_ROW;  // bytes of one K or V tile
  constexpr int N64 = HDP / 64, N16 = HDP % 64 / 16;  // p.v column chunks of 64 and 16
  static_assert(!(DOTS && BIAS), "the dot-only modes take no bias");
  static_assert(HDP % 16 == 0 && HDP <= MAX_HD, "HDP: a multiple of 16 up to MAX_HD");
  extern __shared__ __align__(1024) unsigned char ptc_smem[];
  const int L = args.L, D = args.D, kh = args.kh, kw = args.kw, stages = args.stages;
  const int ra = AUG ? args.ra : 0;  // rel atoms of a row (AUG)
  const int smask = stages - 1, sshift = stages == 4 ? 2 : 1;  // u % stages, u / stages
  const int SB = 2 * TILE + ra * BK * ATOM_ROW;      // bytes of a stage
  unsigned char* KV = ptc_smem;                      // [stage][K, V, rel]
  unsigned char* Qs = KV + stages * SB;              // NA atoms of BQ rows
  unsigned char* Qr = Qs + NA * BQ * ATOM_ROW;       // AUG: ra atoms of BQ rel rows
  uint64_t* full = reinterpret_cast<uint64_t*>(Qr + ra * BQ * ATOM_ROW);  // [MAX_STAGES]
  uint64_t* empty = full + MAX_STAGES;                                    // [MAX_STAGES]
  uint64_t* qbar = empty + MAX_STAGES;
  int* idx = reinterpret_cast<int*>(Qr + ra * BQ * ATOM_ROW + BAR_BYTES);  // [stage][BK]
  bf16* Rh = reinterpret_cast<bf16*>(idx + MAX_STAGES * BK);  // BQ x kh
  bf16* Rw = Rh + BQ * kh;                                    // BQ x kw

  const int bh = blockIdx.y, m0 = blockIdx.x * BQ, tid = threadIdx.x, lane = tid & 31;
  // AUG: window w, head h of a (NW, L, nh * D) layout; else bh's own (L, D).
  const int head = AUG ? bh % args.nh : 0, win = AUG ? bh / args.nh : bh;
  const int tiles = (L + BK - 1) / BK, steps = ROWMAX ? 2 * tiles : tiles;
  // kw == BK: n // kw is the tile and n % kw the column (every tile whole);
  // any other kw takes a table of (n // kw, n % kw) per stage.
  const bool kw64 = BIAS && kw == BK, table = BIAS && !kw64;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, table ? 32 : 1);
      mbar_init(empty + i, CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the block's only barrier: the warps part here

  // The warpgroup index through a shuffle, so that ptxas sees the split as
  // warp-uniform: wgmma behind a branch it takes for divergent gets every
  // product serialized (C7520).
  const int wg = __shfl_sync(0xffffffffu, tid / tc::WG, 0);
  if (wg == CONSUMERS / tc::WG) {
    // The producer warp: q, then each step's tiles into stage u % stages as
    // soon as both warpgroups have released the stage's previous step: K,
    // and V where the step forms p.v (the row-max mode's steps tiles ..
    // 2 tiles - 1, every other step), all by TMA from lane 0. With a bias
    // table, every lane first writes two of its entries, and all 32 lanes
    // arrive on the full barrier, so the consumers' wait also acquires the
    // table; otherwise lane 0 alone. AUG's q, K and V boxes are of one head
    // of the 4D maps, and its rel tiles come with q (BQ rows, two boxes an
    // atom) and with each K tile.
    auto box = [&](void* dst, const CUtensorMap* map, int col, int row, uint64_t* bar) {
      if constexpr (AUG)
        tma_box4(dst, map, col, head, row, win, bar);
      else
        tma_box(dst, map, col, row, bh, bar);
    };
    if (lane == 0) {
      mbar_expect(qbar, (NA + ra) * BQ * ATOM_ROW);
#pragma unroll
      for (int a = 0; a < NA; ++a) box(Qs + a * BQ * ATOM_ROW, &maps.q, 64 * a, m0, qbar);
      for (int a = 0; a < ra; ++a)
        for (int r = 0; r < BQ; r += BK)
          tma_box(Qr + (a * BQ + r) * ATOM_ROW, &maps.r, 64 * a, m0 + r, bh, qbar);
    }
    if (lane != 0 && !table) return;
    for (int u = 0; u < steps; ++u) {
      const int st = u & smask;
      if (u >= stages) mbar_wait(empty + st, ((u >> sshift) - 1) & 1);
      const bool pv = !ROWMAX || u >= tiles;
      const int n0 = (ROWMAX && pv ? u - tiles : u) * BK;
      if (table) {  // n // kw and n % kw stay below 2^16: their bias rows must fit
#pragma unroll
        for (int j = lane; j < BK; j += 32) {
          const int n = n0 + j, hq = n / kw;
          idx[st * BK + j] = n < L ? hq | ((n - hq * kw) << 16) : 0;
        }
      }
      if (lane == 0) {
        unsigned char* dst = KV + st * SB;
        mbar_expect(full + st, (pv ? 2 : 1) * TILE + ra * BK * ATOM_ROW);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          box(dst + a * BK * ATOM_ROW, &maps.k, 64 * a, n0, full + st);
          if (pv) box(dst + TILE + a * BK * ATOM_ROW, &maps.v, 64 * a, n0, full + st);
        }
        for (int a = 0; a < ra; ++a)
          tma_box(dst + 2 * TILE + a * BK * ATOM_ROW, &maps.r, 64 * a, n0, bh, full + st);
      } else {
        mbar_arrive(full + st);
      }
    }
    return;
  }

  // The two consumer warpgroups. AUG writes head h's columns of rows nh * D
  // apart.
  bf16* out = args.out + (AUG ? ((long)win * L * args.nh + head) * D : (long)bh * L * D);
  const long ostride = AUG ? (long)args.nh * D : D;
  const int wt = tid & (tc::WG - 1);  // thread of the warpgroup
  const int lr0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // rows lr0, lr0 + 8
  const int cq = 2 * (lane & 3);  // first column (key) of each of the thread's pairs

  // The bias rows of this warpgroup's 64 rows, as bf16 (FLASH: rel * log2 e,
  // rounded); zeros past row L.
  if constexpr (BIAS) {
    const int r0 = m0 + wg * 64, valid = min(max(L - r0, 0), 64);
    auto copy_rows = [&](bf16* dst, const bf16* src, int width) {
      src += ((long)bh * L + r0) * width;
      dst += wg * 64 * width;
      const int n = 64 * width, have = valid * width;
#pragma unroll 4
      for (int i = wt; i < n; i += tc::WG) {
        const bf16 x = i < have ? src[i] : __float2bfloat16(0.f);
        dst[i] = FLASH ? __float2bfloat16(__bfloat162float(x) * LOG2E_F) : x;
      }
    };
    copy_rows(Rh, args.rh, kh);
    copy_rows(Rw, args.rw, kw);
  }
  mbar_wait(qbar, 0);
  if constexpr (FLASH || AUG) {
    // qs = round_bf16(q * q_scale), in place in this warpgroup's rows of
    // each atom (AUG's rel rows stay as they are), then made visible to the
    // tensor cores (async proxy).
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      uint4* rows = reinterpret_cast<uint4*>(Qs + a * BQ * ATOM_ROW + wg * 64 * ATOM_ROW);
#pragma unroll
      for (int c = wt; c < 64 * ATOM_ROW / 16; c += tc::WG) {
        uint4 w = rows[c];
        uint32_t* h = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(h[e]);
          h[e] = tc::pack_bf16(f.x * args.q_scale, f.y * args.q_scale);
        }
        rows[c] = w;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if constexpr (BIAS || FLASH || AUG)  // the warpgroup's 128 threads, named barrier 1 or 2
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(tc::WG) : "memory");

  const bf16 *rh0 = Rh + lr0 * kh, *rh1 = rh0 + 8 * kh;
  const bf16 *rw0 = Rw + lr0 * kw, *rw1 = rw0 + 8 * kw;
  // kw64: rw of rows lr0 and lr0 + 8 at columns 8 j + cq and + 1, packed.
  uint32_t rwp[2][BK / 8];
  if (kw64) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      rwp[0][j] = *reinterpret_cast<const uint32_t*>(rw0 + 8 * j + cq);
      rwp[1][j] = *reinterpret_cast<const uint32_t*>(rw1 + 8 * j + cq);
    }
  }

  // o[c][i], o16[c][i]: row lr0 (i & 2 == 0) or lr0 + 8, column
  // c0 + 8 (i >> 2) + cq + (i & 1) with c0 = 64 c, or 64 N64 + 16 c.
  float o[N64 ? N64 : 1][32], o16[N16 ? N16 : 1][8];
#pragma unroll
  for (int c = 0; c < N64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int c = 0; c < N16; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) o16[c][i] = 0.f;
  float mx0 = -INFINITY, mx1 = -INFINITY;  // row max of s (ROWMAX), rows lr0, lr0 + 8
  float ls0 = 0.f, ls1 = 0.f;              // this thread's part of sum p
  const uint32_t qaddr = tc::smem_u32(Qs) + wg * 64 * ATOM_ROW;  // this warpgroup's rows

  // Step u's tiles are in place (the full barrier's phase u / stages); a
  // step's stage is released once its last product and its table read are
  // done: q.k for the row-max pass, p.v (issued in the next step) for the
  // softmax pass.
  auto begin_step = [&](int u) { mbar_wait(full + (u & smask), (u >> sshift) & 1); };
  auto release = [&](int u) { mbar_arrive(empty + (u & smask)); };
  auto kaddr = [&](int u) { return tc::smem_u32(KV + (u & smask) * SB); };
  // AUG: this warpgroup's rel rows, and the rel depth steps (R' / 16 up).
  const uint32_t raddr = tc::smem_u32(Qr) + wg * 64 * ATOM_ROW;
  const int rsteps = AUG ? args.rs : 0;
  // Issue q.k of the K tile of step u into sp (committed). Step ks of both
  // operands starts 32 bytes into the rows of atom ks / 4 (the hardware
  // applies the swizzle to the sum); 8-row groups 1 KB apart (SBO). AUG adds
  // the rel depth steps to the same chain: rows' rel tile against keys' rel
  // tile.
  auto issue_qk = [&](float (&sp)[32], int u) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sp[i] = 0.f;
    tc::fence_regs(sp);
    tc::wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      tc::mma_qk(sp, desc128(qaddr + (ks >> 2) * BQ * ATOM_ROW + (ks & 3) * 32, 16, 1024),
                 desc128(kaddr(u) + (ks >> 2) * BK * ATOM_ROW + (ks & 3) * 32, 16, 1024), ks);
    if constexpr (AUG) {
      const uint32_t kr = kaddr(u) + 2 * TILE;
#pragma unroll
      for (int rs = 0; rs < PROBE_MAX_R / 16; ++rs)
        if (rs < rsteps)
          tc::mma_qk(sp, desc128(raddr + (rs >> 2) * BQ * ATOM_ROW + (rs & 3) * 32, 16, 1024),
                     desc128(kr + (rs >> 2) * BK * ATOM_ROW + (rs & 3) * 32, 16, 1024), 1);
    }
    tc::wg_commit();
  };
  // Issue p.v of the V tile of step u with the packed p (committed). The V
  // tile is MN-major: 16 keys are 2 KB of rows, 64 columns an atom (LBO);
  // a 16-column chunk starts 32 bytes a chunk into its atom's rows.
  auto issue_pv = [&](const uint32_t (&pa)[BK / 16][4], int u) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t vk = kaddr(u) + TILE + kk * 2048;
      constexpr bool WIDE = N64 == 2;  // one m64n128k16 for both 64-column chunks
      if constexpr (WIDE) mma_pv128(o[0], o[1], pa[kk], desc128(vk, BK * ATOM_ROW, 1024));
#pragma unroll
      for (int c = 0; c < (WIDE ? 0 : N64); ++c)
        mma_pv64(o[c], pa[kk], desc128(vk + c * BK * ATOM_ROW, BK * ATOM_ROW, 1024));
#pragma unroll
      for (int c = 0; c < N16; ++c)
        tc::mma_pv(o16[c], pa[kk],
                   desc128(vk + N64 * BK * ATOM_ROW + 32 * c, BK * ATOM_ROW, 1024));
    }
    tc::wg_commit();
  };
  auto fence_o = [&] {
#pragma unroll
    for (int c = 0; c < N64; ++c) tc::fence_regs(o[c]);
#pragma unroll
    for (int c = 0; c < N16; ++c) tc::fence_regs(o16[c]);
  };
  // s += (rw + rh) on the logits of step u (tile t). sp[4 j + e]: row lr0
  // (e < 2) or lr0 + 8, key t * BK + 8 j + cq + (e & 1).
  auto add_bias = [&](float (&sp)[32], int u, int t) {
    if constexpr (BIAS) {
      if (kw64) {
        const float h0 = __bfloat162float(rh0[t]), h1 = __bfloat162float(rh1[t]);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float2 w0 = unpack_bf16(rwp[0][j]), w1 = unpack_bf16(rwp[1][j]);
          sp[4 * j + 0] += w0.x + h0;
          sp[4 * j + 1] += w0.y + h0;
          sp[4 * j + 2] += w1.x + h1;
          sp[4 * j + 3] += w1.y + h1;
        }
      } else {
        const int* id = idx + (u & smask) * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int2 hw = *reinterpret_cast<const int2*>(id + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int hq = (e ? hw.y : hw.x) & 0xffff, wq = (e ? hw.y : hw.x) >> 16;
            sp[4 * j + e] += __bfloat162float(rw0[wq]) + __bfloat162float(rh0[hq]);
            sp[4 * j + 2 + e] += __bfloat162float(rw1[wq]) + __bfloat162float(rh1[hq]);
          }
        }
      }
    }
  };
  // Is sp[i] of the tile at n0 a key past L? (sp[i]: row lr0 when i & 2 is
  // 0, else lr0 + 8; key n0 + 8 (i >> 2) + cq + (i & 1).)
  auto absent = [&](int n0, int i) { return n0 + 8 * (i >> 2) + cq + (i & 1) >= L; };

  float sp[32];
  if constexpr (ROWMAX) {  // the row-max pass: steps 0 .. tiles - 1
    for (int t = 0; t < tiles; ++t) {
      begin_step(t);
      issue_qk(sp, t);
      tc::wg_wait_all();
      tc::fence_regs(sp);
      add_bias(sp, t, t);
      release(t);
      const bool tail = (t + 1) * BK > L;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float s = tail && absent(t * BK, i) ? -INFINITY : sp[i];
        if (i & 2) mx1 = fmaxf(mx1, s); else mx0 = fmaxf(mx0, s);
      }
    }
    // A row's max is spread over the four lanes of a quad.
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
  }

  // The softmax pass. Step u issues q.k of tile t and p.v of tile t - 1
  // together and waits for both; it then forms tile t's p, packed into pa,
  // the register operand of the next step's p.v, with no product in flight.
  const int u0 = ROWMAX ? tiles : 0;
  uint32_t pa[BK / 16][4];
  for (int t = 0; t < tiles; ++t) {
    const int u = u0 + t;
    begin_step(u);
    issue_qk(sp, u);
    if (t > 0) issue_pv(pa, u - 1);
    tc::wg_wait_all();
    tc::fence_regs(sp);
    tc::fence_u32(pa);
    fence_o();
    if (t > 0) release(u - 1);
    add_bias(sp, u, t);
    const int n0 = t * BK;
    const bool tail = n0 + BK > L;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float p2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 8 * kk + 2 * f + h;
          float p;
          if constexpr (DOTS)
            p = sp[i];
          else if constexpr (FLASH)
            p = tc::ex2(fminf(fmaxf(sp[i], CLAMP_FLOOR), CLAMP_CAP) - CLAMP_CAP);
          else if constexpr (MODE == PROBE_CLAMP)
            p = ex2_sub(fminf(sp[i], PAIR_CAP) - PAIR_CAP);
          else if constexpr (EXP2)
            p = ex2_sub(sp[i] - ((i & 2) ? mx1 : mx0));
          else
            p = ex2_sub((sp[i] - ((i & 2) ? mx1 : mx0)) * LOG2E_F);
          if (tail && absent(n0, i)) p = 0.f;
          if constexpr (!DOTS) ((i & 2) ? ls1 : ls0) += p;
          p2[h] = p;
        }
        pa[kk][f] = DOTS ? tc::pack_bf16(p2[0], p2[1]) : pack_carried(p2[0], p2[1]);
      }
  }
  fence_o();
  tc::wg_fence();
  issue_pv(pa, u0 + tiles - 1);
  tc::wg_wait_all();
  tc::fence_u32(pa);
  fence_o();

  // A row's sum is spread over the four lanes of a quad (DOTS has none).
#pragma unroll
  for (int sh = 1; sh <= (DOTS ? 0 : 2); sh <<= 1) {
    ls0 += __shfl_xor_sync(0xffffffffu, ls0, sh);
    ls1 += __shfl_xor_sync(0xffffffffu, ls1, sh);
  }
  const float r0 = 1.f / ls0, r1 = 1.f / ls1;
  // out = round_bf16((o' * r) * 2^-64), DOTS' round_bf16(o), a pair of
  // columns at a time.
  auto store = [&](const auto& acc, int c0) {
    constexpr int NACC = std::extent<std::remove_reference_t<decltype(acc)>>::value;
#pragma unroll
    for (int i = 0; i < NACC; i += 2) {
      const int m = m0 + lr0 + ((i & 2) ? 8 : 0), c = c0 + 8 * (i >> 2) + cq;
      const float r = (i & 2) ? r1 : r0;
      const float y0 = DOTS ? acc[i] : acc[i] * r * (1.f / tc::P_SCALE);
      const float y1 = DOTS ? acc[i + 1] : acc[i + 1] * r * (1.f / tc::P_SCALE);
      if (m >= L || c >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + m * ostride + c) = __floats2bfloat162_rn(y0, y1);
    }
  };
#pragma unroll
  for (int c = 0; c < N64; ++c) store(o[c], 64 * c);
#pragma unroll
  for (int c = 0; c < N16; ++c) store(o16[c], 64 * N64 + 16 * c);
}

// The (BH, L, D) operand at x as a 3D tensor map of boxes of 64 columns by
// `rows` rows of one head in the 128-byte swizzle; past L and past D the
// box reads zeros.
inline bool encode(CUtensorMap* map, const void* x, int BH, int L, int D, int rows) {
  const auto fn = samq_tma::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1}, estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned(const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

// Launch probe_tc_kernel<MODE, EXP2, BIAS, HDP> with HDP = D rounded up to 16
// on a grid of (L / BQ up, BH) blocks: four ring stages where they fit
// beside the fixed shared memory, else two (a power of two: the stage and
// phase of a step are a mask and a shift); a shape that leaves no room for
// two is refused.
template <int MODE, bool EXP2, bool BIAS>
inline int launch_body(const Maps& maps, Args a, int BH, cudaStream_t stream) {
  return tc::dispatch_hdp(a.D, [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    const size_t fixed = fixed_bytes(HDP, a.kh, a.kw, a.ra), stage = stage_bytes(HDP, a.ra);
    a.stages = fixed + MAX_STAGES * stage <= (size_t)MAX_SMEM ? MAX_STAGES : 2;
    if (fixed + a.stages * stage > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
    const size_t bytes = fixed + a.stages * stage;
    const auto kernel = probe_tc_kernel<MODE, EXP2, BIAS, HDP>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.L + BQ - 1) / BQ, BH);
    kernel<<<grid, THREADS, bytes, stream>>>(maps, a);
    return (int)cudaGetLastError();
  });
}

// Launch the body on (BH, L, D) bf16 operands, D <= MAX_HD a multiple of 8,
// q, k and v 16-byte aligned and out 4-byte aligned (what TMA and the paired
// stores take); with BIAS, rh (BH, L, kh) and rw (BH, L, kw) with kh * kw ==
// L, whose 128 x (kh + kw) rows of a block must leave room for two ring
// stages. Anything else is refused.
template <int MODE, bool EXP2, bool BIAS>
inline int run(const void* q, const void* k, const void* v, const void* rh, const void* rw,
               void* out, int BH, int L, int D, int kh, int kw, float q_scale,
               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (D % 8 != 0 || !aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) || !aligned(out, 4))
    return (int)cudaErrorInvalidValue;
  if (BIAS ? (rh == nullptr || rw == nullptr || kh < 1 || kw < 1 || (long)kh * kw != L)
           : (kh != 0 || kw != 0))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!(encode(&maps.q, q, BH, L, D, BQ) && encode(&maps.k, k, BH, L, D, BK) &&
        encode(&maps.v, v, BH, L, D, BK)))
    return (int)cudaErrorNotSupported;
  const Args a{static_cast<bf16*>(out), static_cast<const bf16*>(rh),
               static_cast<const bf16*>(rw), L, D, kh, kw, 0, q_scale, 1, 0, 0};
  return launch_body<MODE, EXP2, BIAS>(maps, a, BH, stream);
}

}  // namespace ptc
}  // namespace samq
