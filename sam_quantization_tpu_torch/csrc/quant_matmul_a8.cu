// Int8-activation (W-A8) dequant-matmul on block-planar packed weights, for
// activations already quantized per token (xq int8, scale xs[m]):
//   sym:  out[m, n] = xs[m] * sum_seg s_g[n] * (xq @ (w - mid))[m, n]
//   asym: out[m, n] = xs[m] * sum_seg s_g[n] * ((xq @ (w - off))[m, n]
//                                              - (z_g[n] - off) * rowsum_seg(xq)[m])
// with mid = 2^(bits - 1), off = 128 at 8 bits and 0 below, and the output
// in x's type (float32 or bfloat16). A segment is a scale group cut at the
// K tiles (tile_rows(pb) rows, whole pack blocks): its integer dot is exact
// in int32, converted to float32 and scaled once, in the segment order, as
// the TPU kernels do.
//
// Replaces: sam_quantization_tpu/ops/quant_matmul.py::_qmm_a8_sym_kernel
// (:369-406, launched by _qmm_a8_sym_call :414-447 through
// _quant_matmul_a8_sym :460-484) and ::_qmm_a8_kernel (:279-316, launched by
// _qmm_a8_call :325-358 through _quant_matmul_a8_asym :487-516). The TPU
// writes the float32 accumulator and multiplies by the token scale outside
// the kernel; here that multiply and the cast are the kernel's epilogue, in
// the same float32 order, which saves an (M, N) float32 round trip. The TPU
// wrapper's M padding and its replication of scale rows to a
// (num_k, groups_per_bk, N) array are Mosaic tiling; here ragged M and N are
// masked and scales are indexed by k / groupsize.
//
// What bounds it on an H100: at ViT-H (qkv: M 4900, K 1280, N 3840, 4-bit,
// g 128) the product is 48.2 G integer operations against ~46.5 MB moved
// (xq 6.3 MB, bf16 out 37.6 MB, packed words and scales 2.6 MB): 24 us of
// int8 tensor-core time against 14 us of memory, so it is bound by
// operations. Three more costs grow with M x N, not with the operations:
// every segment's int32 sums are folded into float32 (at g 128, 10 folds of
// 4900 x 3840 values, 4 instructions each sym, 6 asym: ~25 us of issue on
// 132 SMs), every row block decodes the weights again (M / 128 times, about
// an instruction a value), and shared memory carries ~125 KB a K tile (the
// operands re-read by each warpgroup, the copies in, the decode, the
// scales), ~1000 cycles at 128 bytes a cycle against ~600 of products.
//
// Main build (FINE = false; a8tc below): warp-specialized, on Hopper's int8
// warpgroup MMA. A block is three warpgroups and owns a (BM, BN) output
// tile: warpgroup 0 produces, warpgroups 1 and 2 consume the first and the
// second half of its rows. The body is a template on the tile; the default is 128 x 128,
// and 256 x 128 and 256 x 64 (the tiles of ops/autotune.py's table) are
// instantiated too: a 256-row tile decodes the weights half as often (M /
// 256 times) and each consumer then runs two m64 chains a segment, one
// after the other into one int32 set (a8tc::Tile has the register budget).
// Every tile walks K in the same tiles and segments, in the same order, so
// each output is the same float32 sum whatever the tile: the tiles give the
// same bits.
// - Products: wgmma.m64n144k32.s32.s8.u8 (m64n80k32 at 64 columns) with
//   both operands K-major in shared memory (8-bit wgmma takes no
//   transpose), in the 128-byte swizzle:
//   x [m][k] by TMA (rows past M, columns past K zero-filled), the weights
//   [n][k] as the producer decodes them. A K tile of 128 int8 is one swizzle
//   row, a k step 32 bytes further into it, a tile a chain of four.
// - Raw weights: B is u8 and holds the grid values 0..2^bits - 1 as they
//   are, so the decode is mask, shift and byte permutes (four word rows of a
//   column hold four consecutive k of every plane: a 4x4 byte transpose by
//   prmt, stored at addresses that differ by XORs), and mid (sym) or off
//   (asym, 8 bits) moves to the segment's int32 sum: d = xq.w - sub *
//   rowsum, the same integer as xq.(w - sub).
// - Row sums: 16 rows of ones under each weight tile make B BN + 16 wide;
//   the product's last 16 columns hold each row's sum over the segment, in the
//   accumulator layout, so each thread has the sums of its own two rows.
// - Fold: a segment (a group of 32 or 64 rows, or the tile; other groups
//   take FINE) is one chain into an int32 set (scale-d 0 on its first step,
//   no clearing: ptxas serializes every wgmma if an accumulator is written
//   while a chain is in flight), a wait, then float32 without a conversion
//   instruction (the bits of 1.5 * 2^23 + d, less 1.5 * 2^23: exact for |d|
//   < 2^22, and a segment's |d| is below 127 * 128 * 128), multiplied and
//   added as the plain version does, never an FMA. The other consumer's
//   chain can run while one folds.
// - Ring: stages of (x tile 16 KB at 128 rows, weight tile with its ones 18
//   KB at 128 columns, the tile's raw words and the scales of its k steps as
//   cp.async leaves them), as many as fit, at most four (three for most
//   256 x 128 layouts). The producer copies tile u into stage u % STAGES
//   once its empty barrier says both consumers are done with tile u -
//   STAGES (x by TMA from one thread; the words and scales by cp.async, 16
//   bytes a copy where N % 4 == 0), decodes
//   tile u - 2, and each producer thread arrives on that stage's full
//   barrier (with the TMA's bytes, 129 arrivals).
// - Epilogue: times the token scale, the cast, the tile staged in the ring
//   and written in 16-byte rows, ragged M and N masked.
// Tried on the card and dropped (NVIDIA H100 80GB HBM3, 700 W; ViT-H qkv,
// sym, bf16, ms; timed as tools/a8_timing.py times, variant builds not
// kept; the body above reads 0.1255-0.1295 there, the mma.sync body
// 0.2961-0.2969 in the same call; masking before the byte transpose, four
// transposes an item at 4 bits, read 2-3% slower than transposing first):
// - one block of two warpgroups doing copies, decode, products and fold in
//   turn, with two int32 sets so the next segment's chain ran during the
//   fold: 0.2146, then 0.204 without the clearing of the sets, then 0.175
//   with the copies' address arithmetic out of the loop; copies, decode and
//   fold stayed in series at 8 warps an SM (clock() phases put the products
//   at a small part of each K tile);
// - this split with a separate wgmma.m64n8k32 against an 8-row tile of ones
//   for the row sums: 0.1437 (the n144 form saves its A reads);
// - the words and scales by TMA (four 32-column boxes in the 128-byte
//   swizzle) and the consumers' chains in strict turns (named barriers):
//   0.140-0.144 (one thread issuing six copies a tile held the producer);
//   the turns alone: 0.138-0.140;
// - two producer warpgroups (512 threads) with setmaxnreg: ptxas kept 128
//   registers a thread, spilled ~190 bytes and serialized the wgmma: 0.153;
// - persistent blocks (one an SM walking the output tiles, the epilogue
//   stored from registers in column pairs): 0.150.
//
// FINE build (FINE = true): the first version's body on the Ampere-era
// mma.sync.m16n8k32.s8, for the layouts the main build does not take:
// groups that end inside a 32-deep k step (groupsize % 32 != 0; the packing
// makes it a multiple of 4, and each A register holds 4 consecutive k) and
// groups other than 32, 64, whole tiles or all of K; K tiles of other than
// 128 rows (pack blocks that do not divide 128: tile_rows); pack blocks of
// fewer than four word rows a plane (2-bit groups of 32); x that TMA cannot
// address (K % 16 != 0, or xq not 16-byte aligned). One block of 8 warps
// owns a (128, 128) output tile and walks K in tiles of whole pack blocks,
// zero-padded to whole 32-deep k steps; x by cp.async, the words decoded as
// w - mid or w - off into an int8 [n][k] tile, both double-buffered. Each
// warp owns a 32 x 64 sub-tile; a step runs once per segment it holds, with
// the A registers outside the segment zeroed, and each segment reads its
// own scale (and zero) from device memory when it is folded; the
// asymmetric rowsum is dp4a of the A registers. The segments and their
// float32 order are the same as above. No ViT-H serving layer runs it.
#include "qmm_tc.cuh"

namespace samq_quant {

constexpr int A8_THREADS = 256;     // FINE build: 8 warps
constexpr int KSTEP = 32;           // k of one int8 product step
constexpr int KSTEPS = KT / KSTEP;  // most k steps of a K tile

template <int BITS, bool SYM>
__host__ __device__ constexpr int a8_sub() {
  return SYM ? 1 << (BITS - 1) : (BITS == 8 ? 128 : 0);
}

enum A8Flags { X_VEC = 1, W_VEC = 2, OUT_VEC = 4 };

// ============================================================== FINE build

constexpr int A8_BM = 128, A8_BN = 128;
constexpr int A8_LD = KT + 16;      // int8 row pitch: 144 B = 36 words, fragment loads conflict-free
constexpr size_t A8_BUF = (size_t)(A8_BM + A8_BN) * A8_LD + 2 * KSTEPS * A8_BN * sizeof(float);
constexpr size_t A8_SMEM = 2 * A8_BUF;

// The packed words of one (kt, A8_BN) weight tile, and the scales (and
// zeros less off) of its k steps, held in registers between load() and
// store(). An item is four consecutive word rows of one column; a warp's
// lanes take up to four items down K and eight or sixteen columns across,
// so the 32-bit stores of store() fall in distinct banks. Word rows from
// kt / PER on (past the tile) load as zeros and are not stored.
template <int BITS, bool SYM>
struct Int8WeightTile {
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int Q = KT / PER / 4;  // items down a full tile's word rows
  static constexpr int QL = Q < 4 ? Q : 4;
  static constexpr int CL = 32 / QL;
  static constexpr int ITEMS = Q * A8_BN / A8_THREADS;
  static constexpr int SITEMS = KSTEPS * A8_BN / A8_THREADS;
  static constexpr int SUB = a8_sub<BITS, SYM>();
  static_assert(Q * A8_BN % A8_THREADS == 0 && KSTEPS * A8_BN % A8_THREADS == 0, "whole items");
  int w[ITEMS][4];
  float sc[SITEMS], zr[SITEMS];

  __device__ __forceinline__ static void item(int p, int& q, int& c) {
    const int l = p & 31, wi = p >> 5;
    q = (wi / (A8_BN / CL)) * QL + l % QL;
    c = (wi % (A8_BN / CL)) * CL + l / QL;
  }

  __device__ __forceinline__ void load(const int32_t* __restrict__ qw,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ zeros, int k0, int K, int n0,
                                       int N, int groupsize, int kt) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      int q, c;
      item(threadIdx.x + it * A8_THREADS, q, c);
      const int n = n0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // The tile holds whole pack blocks, so its word row r is k0 / PER + r.
        const int r = 4 * q + j, gr = k0 / PER + r;
        w[it][j] = (r < kt / PER && gr < K / PER && n < N) ? __ldg(qw + (long)gr * N + n) : 0;
      }
    }
#pragma unroll
    for (int it = 0; it < SITEMS; ++it) {
      const int e = threadIdx.x + it * A8_THREADS;
      const int ks = e / A8_BN, k = k0 + ks * KSTEP, n = n0 + e % A8_BN;
      const bool in = ks * KSTEP < kt && k < K && n < N;
      const long gi = (long)(k / groupsize) * N + n;
      sc[it] = in ? __ldg(scales + gi) : 0.f;
      if constexpr (!SYM) zr[it] = in ? __fsub_rn(__ldg(zeros + gi), (float)SUB) : 0.f;
    }
  }

  // Ws[c * A8_LD + r] = w[k0 + r, n0 + c] - SUB as int8; Ss / Zs[ks * A8_BN + c].
  __device__ __forceinline__ void store(int8_t* Ws, float* Ss, float* Zs, int pb, int kt) const {
    const int rpp = pb / PER;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      int q, c;
      item(threadIdx.x + it * A8_THREADS, q, c);
      if (4 * q >= kt / PER) continue;
      int8_t* col = Ws + c * A8_LD;
      if (rpp % 4 == 0) {  // the four word rows hold four consecutive k of each plane
        int i0, row0;
        locate_row(4 * q, rpp, pb, i0, row0);
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          unsigned v = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v |= (unsigned)((grid_value<BITS>(w[it][j], 0, s, 0) - SUB) & 0xff) << (8 * j);
          *reinterpret_cast<unsigned*>(col + row0 + s * rpp + i0) = v;
        }
      } else {  // pack blocks of fewer than 4 * PER rows: byte by byte
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j >= kt / PER) break;
          int i, row0;
          locate_row(4 * q + j, rpp, pb, i, row0);
#pragma unroll
          for (int s = 0; s < PER; ++s)
            col[row0 + s * rpp + i] = (int8_t)(grid_value<BITS>(w[it][j], 0, s, 0) - SUB);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < SITEMS; ++it) {
      const int e = threadIdx.x + it * A8_THREADS;
      Ss[e] = sc[it];
      if constexpr (!SYM) Zs[e] = zr[it];
    }
  }
};

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// c += a (16x32, row) * b (32x8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BITS, bool SYM, typename T>
__device__ __forceinline__ void a8_fine(unsigned char* smem, const int8_t* __restrict__ xq,
                                        const float* __restrict__ xs,
                                        const int32_t* __restrict__ qw,
                                        const float* __restrict__ scales,
                                        const float* __restrict__ zeros, T* __restrict__ out,
                                        int M, int K, int N, int pb, int groupsize, bool vec) {
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);             // 2 x BM x LD
  int8_t* Ws = Xs + 2 * A8_BM * A8_LD;                        // 2 x BN x LD
  float* Ss = reinterpret_cast<float*>(Ws + 2 * A8_BN * A8_LD);  // 2 x KSTEPS x BN
  float* Zs = Ss + 2 * KSTEPS * A8_BN;                        // 2 x KSTEPS x BN
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the mma fragments' row group and lane in it
  const int m0 = blockIdx.x * A8_BM, n0 = blockIdx.y * A8_BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int kt = tile_rows(pb), ksteps = (kt + KSTEP - 1) / KSTEP;
  const int tiles = (K + kt - 1) / kt;

  // acc: float32 sums of finished segments; iacc: int32 sums of the current
  // one; rsp: this lane's part of the rowsum of rows gid and gid + 8.
  float acc[2][8][4];
  int iacc[2][8][4], rsp[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rsp[i][0] = rsp[i][1] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f, iacc[i][j][r] = 0;
  }

  // Weight rows kt .. 32 * ksteps - 1 of both buffers are never stored: zeros.
  for (int i = threadIdx.x; i < 2 * A8_BN * (ksteps * KSTEP - kt); i += A8_THREADS) {
    const int b = i / (A8_BN * (ksteps * KSTEP - kt)), j = i % (A8_BN * (ksteps * KSTEP - kt));
    Ws[b * A8_BN * A8_LD + (j % A8_BN) * A8_LD + kt + j / A8_BN] = 0;
  }

  // Tile t sits in buffer t % 2; while tile t is multiplied, the x copy of
  // tile t + 1 and the word loads of tile t + 2 are in flight.
  Int8WeightTile<BITS, SYM> wt;
  copy_x_tile_async<int8_t, A8_BM, KT, A8_THREADS>(Xs, A8_LD, xq, m0, M, 0, K, kt, vec);
  wt.load(qw, scales, zeros, 0, K, n0, N, groupsize, kt);
  wt.store(Ws, Ss, Zs, pb, kt);
  if (tiles > 1) wt.load(qw, scales, zeros, kt, K, n0, N, groupsize, kt);
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in place; step t - 1's products are done with buffer nxt
    if (t + 1 < tiles) {
      copy_x_tile_async<int8_t, A8_BM, KT, A8_THREADS>(Xs + nxt * A8_BM * A8_LD, A8_LD, xq, m0,
                                                       M, (t + 1) * kt, K, kt, vec);
      wt.store(Ws + nxt * A8_BN * A8_LD, Ss + nxt * KSTEPS * A8_BN, Zs + nxt * KSTEPS * A8_BN,
               pb, kt);
      if (t + 2 < tiles) wt.load(qw, scales, zeros, (t + 2) * kt, K, n0, N, groupsize, kt);
    }
    const int8_t* xt = Xs + cur * A8_BM * A8_LD;
    const int8_t* wt_s = Ws + cur * A8_BN * A8_LD;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k = t * kt + ks * KSTEP, kk = ks * KSTEP, tend = min(t * kt + kt, K);
      if (ks >= ksteps || k >= K) break;
      unsigned a[2][4], b[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r = xt + (wm + 16 * i + gid) * A8_LD + kk + 4 * tig;
        a[i][0] = lds32(r);
        a[i][1] = lds32(r + 8 * A8_LD);
        a[i][2] = lds32(r + 16);
        a[i][3] = lds32(r + 8 * A8_LD + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* c = wt_s + (wn + 8 * j + gid) * A8_LD + kk + 4 * tig;
        b[j][0] = lds32(c);
        b[j][1] = lds32(c + 16);
      }
      // Fold the segment's int32 sums into acc, (d - zr * rowsum) * s (or
      // d * s), with s and zr of tile column c from sz(c, s, zr).
      auto fold = [&](auto&& sz) {
        int rs[2][2];
        if constexpr (!SYM) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int v = rsp[i][h];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              rs[i][h] = v;
              rsp[i][h] = 0;
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s, zr = 0.f;
            sz(wn + 8 * j + 2 * tig + e, s, zr);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 2 * h + e;
                const float d = __int2float_rn(iacc[i][j][r]);
                float term;
                if constexpr (SYM) {
                  term = __fmul_rn(d, s);
                } else {
                  const float zrs = __fmul_rn(zr, __int2float_rn(rs[i][h]));
                  term = __fmul_rn(__fsub_rn(d, zrs), s);
                }
                acc[i][j][r] = __fadd_rn(acc[i][j][r], term);
                iacc[i][j][r] = 0;
              }
          }
      };
      // The products of the A registers a2 (one k range per register,
      // zeros outside the segment) with the B tile, and their rowsums.
      auto step = [&](const unsigned (&a2)[2][4]) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_s8(iacc[i][j], a2[i], b[j]);
        if constexpr (!SYM) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ones = 0x01010101;
            rsp[i][0] = __dp4a((int)a2[i][2], ones, __dp4a((int)a2[i][0], ones, rsp[i][0]));
            rsp[i][1] = __dp4a((int)a2[i][3], ones, __dp4a((int)a2[i][1], ones, rsp[i][1]));
          }
        }
      };
      // Segments [lo, hi) of the step, cut at the group boundaries and at
      // the tile's end (tend: rows past it are zeros); the step's registers
      // hold k + 4 * tig (a0, a1) and k + 16 + 4 * tig (a2, a3).
      const int klo = k + 4 * tig, khi = klo + 16;
      for (int lo = k; lo < k + KSTEP && lo < tend;) {
        const int g = lo / groupsize, hi = min(min((g + 1) * groupsize, k + KSTEP), tend);
        const bool inl = lo <= klo && klo < hi, inh = lo <= khi && khi < hi;
        unsigned am[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          am[i][0] = inl ? a[i][0] : 0u;
          am[i][1] = inl ? a[i][1] : 0u;
          am[i][2] = inh ? a[i][2] : 0u;
          am[i][3] = inh ? a[i][3] : 0u;
        }
        step(am);
        if (hi % groupsize == 0 || hi >= tend)
          fold([&](int c, float& s, float& zr) {
            const int n = n0 + c;
            const long gi = (long)g * N + n;
            s = n < N ? __ldg(scales + gi) : 0.f;
            if constexpr (!SYM) {
              constexpr float sub = Int8WeightTile<BITS, SYM>::SUB;
              zr = n < N ? __fsub_rn(__ldg(zeros + gi), sub) : 0.f;
            }
          });
        lo = hi;
      }
    }
  }

  // Epilogue: the token scale, then the cast, in x's type.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + gid + 8 * h;
      if (m >= M) continue;
      const float xsm = __ldg(xs + m);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + 8 * j + 2 * tig + e;
          if (n < N) out[(long)m * N + n] = from_f32<T>(__fmul_rn(acc[i][j][2 * h + e], xsm));
        }
    }
}

// ============================================================== main build

namespace a8tc {

using tc::desc;
using samq_tma::mbar_arrive;
using samq_tma::mbar_init;
using samq_tma::mbar_wait;
using tc::smem_u32;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait_all;

constexpr int PT = 128, CT = 256;        // producer and consumer threads
constexpr int NT = PT + CT;              // one producer warpgroup, two consumer warpgroups
constexpr int MAX_STAGES = 4;
constexpr int AHEAD = 2;                 // tiles the producer's copies run ahead of its decode
constexpr int MAGIC = 0x4B400000;        // the bits of 1.5 * 2^23
constexpr float MAGIC_F = 12582912.f;    // 1.5 * 2^23

// The block's (BM, BN) output tile: the default 128 x 128, and 256 x 128
// and 256 x 64, the tiles ops/autotune.py's table can name. Each consumer
// warpgroup owns BM / 2 rows, MW row blocks of 64, and runs one chain a row
// block into one int32 set of m64n(BN + 16) (the weight tile and 16 columns
// of ones), folding it into that row block's float32 sums before the next
// chain. Accumulators a consumer thread: (BN + 16) / 2 int32 and MW * BN / 2
// float32: 136 at 128 x 128, 104 at 256 x 64, 200 at 256 x 128. The last
// does not fit the 168 registers a thread that 384 threads leave, so there
// the producer gives registers to the consumers (setmaxnreg: 72 a producer
// thread, 216 a consumer one, 128 * 72 + 256 * 216 = 384 * 168) and decodes
// two items at a time. The split was read from ptxas's reports (the CUDA
// 12 toolkit of an H100 machine), the first with no spill at any bits:
// at 40 / 232 the producer spilled 68-204 bytes a thread, at 88 / 200 the
// consumers 48-88; a new toolkit may want it read again.
template <int BM, int BN>
struct Tile {
  static_assert((BM == 128 && BN == 128) || (BM == 256 && (BN == 128 || BN == 64)),
                "an instantiated tile");
  static constexpr int MW = BM / 128;          // row blocks of a consumer
  static constexpr int NB = BN + 16;           // B rows: the weight tile and 16 rows of ones
  static constexpr int NACC = NB / 2;          // int32 sums a thread
  static constexpr int X_BYTES = BM * KT;      // x tile of a stage, [m][k] int8
  static constexpr int W_BYTES = NB * KT;      // weight tile [n][k] u8 and the ones
  static constexpr int SC_FLOATS = KSTEPS * BN;  // scales (or zeros) of a tile's k steps
  static constexpr int LDO = BN + 8;           // epilogue staging pitch, values (rows 4 or 8 banks apart)
  static constexpr bool SPLIT_REGS = MW * BN / 2 + NACC > 168 - 24;  // about 24 not accumulators
  static constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;
  static constexpr int DECODE_UNR = 2;  // decode items unrolled together under SPLIT_REGS
  static_assert(PT * PRODUCER_REGS + CT * CONSUMER_REGS <= NT * 168, "the block's registers");
};

// A stage: x tile, weight tile with its rows of ones, the tile's raw words
// ([word row][column], 16-byte chunks swizzled, see raw_col), scales and,
// asymmetric, zeros. As many stages as fit, at most four: three at 256 x
// 128 but at 2 bits symmetric.
template <int BITS, bool SYM, int BM, int BN>
struct Layout {
  using Tl = Tile<BM, BN>;
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int WR = KT / PER;  // word rows of a tile
  static constexpr int RAW = WR * BN * 4;
  static constexpr int SCALES = Tl::X_BYTES + Tl::W_BYTES + RAW;
  static constexpr int STAGE = SCALES + Tl::SC_FLOATS * 4 * (SYM ? 1 : 2);
  static constexpr int FIT = (MAX_SMEM - 1024) / (STAGE + 16);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BARS = STAGES * STAGE;  // full and empty mbarriers of each stage
  static constexpr size_t SMEM = BARS + 16 * STAGES + 1024;  // + room to align the base to 1 KB
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle atoms 1 KB aligned");
  static_assert(STAGES > AHEAD, "a stage is refilled only after its tile was decoded");
  static_assert(SMEM <= MAX_SMEM, "shared memory of a block");
  static_assert(STAGES * STAGE >= BM * Tl::LDO * 4, "the epilogue fits in the ring");
};

// Word (wr, c) of a stage's raw words sits at column raw_col(wr, c) of row
// wr: the four word rows of a decode item share a swizzle, and the four
// items a warp takes down K read distinct banks.
__device__ __forceinline__ int raw_col(int wr, int c) { return c ^ (((wr >> 2) & 3) << 3); }

template <int R>
__device__ __forceinline__ void fence_iregs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 144, s32) = [d +] a (64 x 32, s8, K-major) * b (32 x 144, u8,
// K-major), both in shared memory. Columns 128-143 of b are ones, so d's
// columns 128-143 hold the sums of a's rows.
__device__ __forceinline__ void mma_n144(int (&d)[72], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same at n 80 (a 64-column weight tile and its 16 columns of ones).
__device__ __forceinline__ void mma_n80(int (&d)[40], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int NACC>
__device__ __forceinline__ void mma_wg(int (&d)[NACC], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (NACC == 72) mma_n144(d, a, b, accumulate);
  else mma_n80(d, a, b, accumulate);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool in) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(in ? 4 : 0));
}

// x tile t (BM rows from m0, 128 columns) into a stage by TMA.
template <int BM>
__device__ __forceinline__ void tma_x(unsigned char* dst, uint64_t* bar, const CUtensorMap* map,
                                      int k0, int m0) {
  samq_tma::mbar_expect(bar, BM * KT);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(m0), "r"(smem_u32(bar))
      : "memory");
}

// The raw words of tile t (word rows t * WR.., columns n0..) and the scales
// (and zeros) of its k steps into a stage, by cp.async from the producer
// threads (p = 0..127); zeros past K and N. `vec` (N % 4 == 0, 16-byte
// aligned buffers): a thread's copies are fixed for the block, 16 bytes
// each: word rows p / CPR + RP j, columns 4 (p % CPR) (CPR = BN / 4 copies
// a word row, RP = 128 / CPR word rows a pass), and the scales (and zeros)
// of the tile's k steps in the same order. Otherwise word by word.
template <int BITS, bool SYM, int BM, int BN>
__device__ __forceinline__ void copy_words(unsigned char* st, const int32_t* __restrict__ qw,
                                           const float* __restrict__ scales,
                                           const float* __restrict__ zeros, int t, int K, int n0,
                                           int N, int groupsize, int gshift, int p, bool vec) {
  using L = Layout<BITS, SYM, BM, BN>;
  using Tl = Tile<BM, BN>;
  constexpr int SCF = Tl::SC_FLOATS;
  int32_t* raw = reinterpret_cast<int32_t*>(st + Tl::X_BYTES + Tl::W_BYTES);
  float* sc = reinterpret_cast<float*>(st + L::SCALES);
  const int k0 = t * KT, wr0 = t * L::WR, wrows = K / L::PER;
  auto row = [&](int k) { return gshift >= 0 ? k >> gshift : k / groupsize; };
  if (vec) {
    constexpr int CPR = BN / 4, RP = PT / CPR;
    static_assert(L::WR % RP == 0, "whole passes of word rows");
    const int r = p / CPR, c = (p % CPR) * 4;
    const bool cin = n0 + c < N;
    const int32_t* wp = qw + (long)(wr0 + r) * N + n0 + c;
#pragma unroll
    for (int j = 0; j < L::WR / RP; ++j) {
      const int wr = r + RP * j;
      const bool in = cin && wr0 + wr < wrows;
      cp_async(raw + wr * BN + raw_col(wr, c), in ? wp + (long)RP * j * N : qw, 16, in);
    }
    // The scales (and zeros) of k step r at columns c (128 columns: RP ==
    // KSTEPS); at 64 columns (RP == 2 KSTEPS) rows r < KSTEPS copy the
    // scales of k step r, the others the zeros of k step r - KSTEPS.
    static_assert(RP == KSTEPS || RP == 2 * KSTEPS, "a k step a row of copies");
    const int a0 = RP == KSTEPS ? 0 : r / KSTEPS, ks = RP == KSTEPS ? r : r % KSTEPS;
    const int k = k0 + ks * KSTEP;
    const bool in = cin && k < K;
#pragma unroll
    for (int a = a0; a < (RP == KSTEPS ? (SYM ? 1 : 2) : a0 + 1); ++a) {
      if (SYM && a) break;
      const float* src = a ? zeros : scales;
      cp_async(sc + a * SCF + ks * BN + c, in ? src + (long)row(k) * N + n0 + c : src, 16, in);
    }
    return;
  }
  for (int i = p; i < L::WR * BN; i += PT) {
    const int wr = i / BN, c = i % BN, n = n0 + c;
    const bool in = wr0 + wr < wrows && n < N;
    cp_async(raw + wr * BN + raw_col(wr, c), in ? qw + (long)(wr0 + wr) * N + n : qw, 4, in);
  }
  for (int i = p; i < (SYM ? 1 : 2) * SCF; i += PT) {
    const int a = i / SCF, ks = i % SCF / BN, c = i % BN;
    const int k = k0 + ks * KSTEP, n = n0 + c;
    const bool in = k < K && n < N;
    const float* src = a ? zeros : scales;
    cp_async(sc + i, in ? src + (long)row(k) * N + n : src, 4, in);
  }
}

// o[b] = byte b of a[0..3], a[0]'s lowest: a 4x4 byte transpose.
__device__ __forceinline__ void transpose4(const unsigned (&a)[4], unsigned (&o)[4]) {
  const unsigned t0 = __byte_perm(a[0], a[1], 0x5140), t1 = __byte_perm(a[0], a[1], 0x7362);
  const unsigned t2 = __byte_perm(a[2], a[3], 0x5140), t3 = __byte_perm(a[2], a[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// Decode a stage's raw words into its weight tile, raw grid values as u8.
// Item (q, c) is word rows 4q..4q+3 of column c: one pack block (rpp % 4 ==
// 0), so each of their planes s holds the four consecutive k from kb + s *
// rpp, which become one 32-bit word of row c. A warp's lanes take up to four
// items down K and eight or sixteen columns across (as Int8WeightTile).
// The tile is K-major in the 128-byte swizzle: 16-byte chunk k / 16 of row
// c sits at chunk (k / 16) ^ (c % 8), so (c, k) is at byte (c * 128 + ((c %
// 8) << 4)) ^ k, and as kb and s * rpp have disjoint bits (powers of two),
// the stores of an item differ by XORs.
template <int BITS, bool SYM, int BM, int BN>
__device__ __forceinline__ void decode(unsigned char* st, int p0, int rsh, int psh) {
  using L = Layout<BITS, SYM, BM, BN>;
  using Tl = Tile<BM, BN>;
  constexpr int Q = L::WR / 4, QL = Q < 4 ? Q : 4, CL = 32 / QL, ITEMS = Q * BN / PT;
  static_assert(Q * BN % PT == 0, "whole items");
  const int32_t* raw = reinterpret_cast<const int32_t*>(st + Tl::X_BYTES + Tl::W_BYTES);
  const uint32_t wt = smem_u32(st + Tl::X_BYTES);
  const int rpp = 1 << rsh;
  auto item = [&](int it) {
    const int p = p0 + it * PT, l = p & 31, wi = p >> 5;
    const int q = (wi / (BN / CL)) * QL + l % QL, c = (wi % (BN / CL)) * CL + l / QL;
    const int wr = 4 * q, kb = ((wr >> rsh) << psh) | (wr & (rpp - 1));
    const int32_t* src = raw + wr * BN + raw_col(wr, c);
    unsigned a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = src[j * BN];
    const uint32_t at = wt + c * 128 + (((c & 7) << 4) ^ kb);
    auto put = [&](int s, unsigned v) {
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at ^ (s << rsh)), "r"(v) : "memory");
    };
    // Byte j of o[b] is byte b of word j, whose bits BITS * m hold plane
    // PARTS * b + m: a shift and a mask a plane.
    constexpr int PARTS = 8 / BITS;
    constexpr unsigned M4 = ((1u << BITS) - 1) * 0x01010101u;
    unsigned o[4];
    transpose4(a, o);
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int m = 0; m < PARTS; ++m) put(PARTS * b + m, (o[b] >> (BITS * m)) & M4);
  };
  if constexpr (Tl::SPLIT_REGS) {  // a few items at a time: the producer has few registers
    constexpr int U = Tl::DECODE_UNR;
    static_assert(ITEMS % U == 0, "whole groups of items");
#pragma unroll 1
    for (int i0 = 0; i0 < ITEMS; i0 += U)
#pragma unroll
      for (int i1 = 0; i1 < U; ++i1) item(i0 + i1);
  } else {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) item(it);
  }
}

// Steps lo..lo + NS - 1 of a stage into d, the first with scale-d 0: each
// step 32 bytes further into the swizzle rows (the hardware applies the
// swizzle to the sum); SBO 1 KB between 8-row groups, LBO unused inside the
// 128-byte atom. xa: the row block's x rows, wb: the weight tile.
template <int NS, int NACC>
__device__ __forceinline__ void chain(int (&d)[NACC], uint32_t xa, uint32_t wb) {
#pragma unroll
  for (int ks = 0; ks < NS; ++ks)
    mma_wg<NACC>(d, desc(xa + ks * 32, 16, 1024), desc(wb + ks * 32, 16, 1024), ks != 0);
}

// One (BM, BN) output tile. Warpgroup 0 produces: tile u's x by TMA and its
// raw words and scales by cp.async into stage u % STAGES (once the
// consumers have freed it), and AHEAD tiles later the decode of its words
// into the stage's weight tile, after which each producer thread arrives on
// the stage's full barrier (with the TMA's bytes, 129 arrivals). Warpgroups
// 1 and 2 consume rows 0.. and BM / 2..: per segment and row block a chain
// of wgmma into one int32 set, a wait, and the fold; then each thread
// arrives on the stage's empty barrier.
template <int BITS, bool SYM, int BM, int BN, typename T>
__device__ __forceinline__ void a8_tc(unsigned char* smem, const CUtensorMap* xmap,
                                      const float* __restrict__ xs,
                                      const int32_t* __restrict__ qw,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ zeros, T* __restrict__ out, int M,
                                      int K, int N, int pb, int groupsize, int flags) {
  using L = Layout<BITS, SYM, BM, BN>;
  using Tl = Tile<BM, BN>;
  constexpr int SUB = a8_sub<BITS, SYM>();
  constexpr int STAGES = L::STAGES, MW = Tl::MW, NACC = Tl::NACC, LDO = Tl::LDO;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tiles = (K + KT - 1) / KT;
  // k steps a segment: groups of 32 or 64 rows, else whole tiles (groups of
  // whole tiles, or one group); run_a8_bits sends other groups to FINE.
  const int gs = groupsize == KSTEP ? 1 : groupsize == 2 * KSTEP ? 2 : KSTEPS;
  // Ring slot of tile t (a mask where STAGES is a power of two).
  auto slot = [](int t) { return (STAGES & (STAGES - 1)) ? t % STAGES : t & (STAGES - 1); };
  auto stage = [&](int t) { return smem + slot(t) * L::STAGE; };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1 + PT), mbar_init(empty + s, CT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < STAGES * 16 * KT / 4; i += NT)  // the rows of ones under each weight tile
    reinterpret_cast<unsigned*>(stage(i / (4 * KT)) + Tl::X_BYTES + BN * KT)[i % (4 * KT)] =
        0x01010101u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------------ producer
    if constexpr (Tl::SPLIT_REGS)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Tl::PRODUCER_REGS));
    const int rsh = __ffs(pb / L::PER) - 1, psh = __ffs(pb) - 1;  // both powers of two here
    const int gshift = (groupsize & (groupsize - 1)) == 0 ? __ffs(groupsize) - 1 : -1;
    const bool wvec = flags & W_VEC;
    for (int u = 0; u < tiles + AHEAD; ++u) {
      if (u < tiles) {
        const int s = slot(u);
        if (u >= STAGES) mbar_wait(empty + s, (u / STAGES - 1) & 1);
        if (tid == 0) tma_x<BM>(stage(u), full + s, xmap, u * KT, m0);
        copy_words<BITS, SYM, BM, BN>(stage(u), qw, scales, zeros, u, K, n0, N, groupsize,
                                      gshift, tid, wvec);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      const int d = u - AHEAD;  // tile d's words: AHEAD groups were committed after them
      if (d < 0) continue;
      if (u < tiles) asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD) : "memory");
      else cp_async_wait_all();
      asm volatile("bar.sync 1, %0;\n" ::"n"(PT) : "memory");  // every producer's copies
      decode<BITS, SYM, BM, BN>(stage(d), tid, rsh, psh);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + slot(d));
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  if constexpr (Tl::SPLIT_REGS)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Tl::CONSUMER_REGS));
  const int cw = wg - 1;  // rows cw * BM / 2.. of the tile
  // The int32 set needs no clearing (each segment's first step has scale-d
  // 0), and must not get any: ptxas serializes every wgmma if a non-wgmma
  // instruction writes an accumulator while a chain is in flight.
  int acci[NACC];
  float acc[MW][BN / 2];
#pragma unroll
  for (int r = 0; r < MW; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;
  const uint32_t base = smem_u32(smem);
  // acci[i] is row 16 (warp % 4) + lane / 4 + 8 ((i >> 1) & 1) of the row
  // block's 64, column 8 (i >> 2) + 2 (lane % 4) + (i & 1), as a[i];
  // acci[BN / 2] and acci[BN / 2 + 2] (columns of ones) are the sums of the
  // two rows.
  auto fold = [&](float (&a)[BN / 2], const float* sc) {
    const int b0 = MAGIC - SUB * acci[BN / 2], b1 = MAGIC - SUB * acci[BN / 2 + 2];
    float rf0 = 0.f, rf1 = 0.f;
    if constexpr (!SYM) rf0 = __int2float_rn(acci[BN / 2]), rf1 = __int2float_rn(acci[BN / 2 + 2]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 s = *reinterpret_cast<const float2*>(sc + c);
      float2 z = make_float2(0.f, 0.f);
      if constexpr (!SYM) {
        z = *reinterpret_cast<const float2*>(sc + Tl::SC_FLOATS + c);
        if constexpr (SUB != 0) z = make_float2(__fsub_rn(z.x, (float)SUB), __fsub_rn(z.y, (float)SUB));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float dv = __fsub_rn(__int_as_float(acci[i] + (h ? b1 : b0)), MAGIC_F);
          const float se = e ? s.y : s.x;
          float term;
          if constexpr (SYM) {
            term = __fmul_rn(dv, se);
          } else {
            term = __fmul_rn(__fsub_rn(dv, __fmul_rn(e ? z.y : z.x, h ? rf1 : rf0)), se);
          }
          a[i] = __fadd_rn(a[i], term);
        }
    }
  };
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    const int s = slot(t);
    mbar_wait(full + s, (t / STAGES) & 1);
    const uint32_t st = base + s * L::STAGE, wb = st + Tl::X_BYTES;
    const float* sc = reinterpret_cast<const float*>(stage(t) + L::SCALES);
#pragma unroll 1
    for (int lo = 0; lo < KSTEPS; lo += gs) {
#pragma unroll
      for (int r = 0; r < MW; ++r) {
        const uint32_t xa = st + (cw * MW + r) * 64 * 128;
        fence_iregs(acci);
        wg_fence();
        if (gs == KSTEPS) chain<KSTEPS>(acci, xa, wb);
        else if (gs == 2) chain<2>(acci, xa + lo * 32, wb + lo * 32);
        else chain<1>(acci, xa + lo * 32, wb + lo * 32);
        wg_commit();
        wg_wait_all();
        fence_iregs(acci);
        fold(acc[r], sc + lo * BN);
      }
    }
    mbar_arrive(empty + s);
  }

  // Epilogue: the token scale, the cast, the tile staged in the ring (once
  // both consumers are done with it; the producer is: every tile was full)
  // and written out in 16-byte rows.
  asm volatile("bar.sync 2, %0;\n" ::"n"(CT) : "memory");
  T* so = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int r = 0; r < MW; ++r) {
    const int r0 = (cw * MW + r) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const float x0 = m0 + r0 < M ? __ldg(xs + m0 + r0) : 0.f;
    const float x1 = m0 + r0 + 8 < M ? __ldg(xs + m0 + r0 + 8) : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * (lane & 3);
        const float v0 = __fmul_rn(acc[r][4 * j + 2 * h], h ? x1 : x0);
        const float v1 = __fmul_rn(acc[r][4 * j + 2 * h + 1], h ? x1 : x0);
        T* dst = so + (r0 + 8 * h) * LDO + c;
        if constexpr (sizeof(T) == 4) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      }
  }
  asm volatile("bar.sync 2, %0;\n" ::"n"(CT) : "memory");
  constexpr int V = 16 / sizeof(T), CH = BN / V;
  const bool ovec = flags & OUT_VEC;
  for (int i = tid - PT; i < BM * CH; i += CT) {
    const int r = i / CH, c = (i % CH) * V, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const T* src = so + r * LDO + c;
    T* dst = out + (long)m * N + n;
    if (ovec && n + V <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < V && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

}  // namespace a8tc

// Both builds behind one kernel: FINE = true runs a8_fine (at its one
// (A8_BM, A8_BN) tile), else a8tc::a8_tc at the (BM, BN) tile.
template <int BITS, bool SYM, bool FINE, int BM, int BN, typename T>
__global__ void __launch_bounds__(FINE ? A8_THREADS : a8tc::NT, 1)
    qmm_a8_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ xq,
                  const float* __restrict__ xs, const int32_t* __restrict__ qw,
                  const float* __restrict__ scales, const float* __restrict__ zeros,
                  T* __restrict__ out, int M, int K, int N, int pb, int groupsize, int flags) {
  extern __shared__ __align__(1024) unsigned char a8_smem[];
  if constexpr (FINE) {
    static_assert(BM == A8_BM && BN == A8_BN, "the FINE build has one tile");
    a8_fine<BITS, SYM, T>(a8_smem, xq, xs, qw, scales, zeros, out, M, K, N, pb, groupsize,
                          flags & X_VEC);
  } else {
    // Swizzle atoms need 1 KB alignment; SMEM leaves room for it.
    const uint32_t mis = tc::smem_u32(a8_smem) & 1023;
    a8tc::a8_tc<BITS, SYM, BM, BN, T>(a8_smem + (mis ? 1024 - mis : 0), &xmap, xs, qw, scales,
                                      zeros, out, M, K, N, pb, groupsize, flags);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int BITS, bool SYM, bool FINE, int BM, int BN>
static int run_a8(int dtype, const int8_t* xq, const float* xs, const int32_t* qw,
                  const float* s, const float* z, void* out, int M, int K, int N, int pb, int g,
                  cudaStream_t stream) {
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  size_t smem = A8_SMEM;
  int flags = vec_ok(xq, K, tile_rows(pb), 16) ? X_VEC : 0;
  if constexpr (!FINE) {
    using L = a8tc::Layout<BITS, SYM, BM, BN>;
    smem = L::SMEM;
    const auto fn = tc::encode_fn();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K};
    const cuuint32_t box[2] = {KT, BM}, estr[2] = {1, 1};
    if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(xq), dims, strides, box,
           estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    if (N % 4 == 0 && aligned16(qw) && aligned16(s) && (SYM || aligned16(z))) flags |= W_VEC;
    if (N % (dtype == 1 ? 8 : 4) == 0 && aligned16(out)) flags |= OUT_VEC;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const int threads = FINE ? A8_THREADS : a8tc::NT;
  if (dtype == 1)
    return launch(qmm_a8_kernel<BITS, SYM, FINE, BM, BN, __nv_bfloat16>, grid, threads, smem,
                  stream, map, xq, xs, qw, s, z, static_cast<__nv_bfloat16*>(out), M, K, N, pb, g,
                  flags);
  return launch(qmm_a8_kernel<BITS, SYM, FINE, BM, BN, float>, grid, threads, smem, stream, map,
                xq, xs, qw, s, z, static_cast<float*>(out), M, K, N, pb, g, flags);
}

template <int BITS>
static int run_a8_bits(int dtype, int sym, const int8_t* xq, const float* xs, const int32_t* qw,
                       const float* s, const float* z, void* out, int M, int K, int N, int pb,
                       int g, int bm, int bn, cudaStream_t stream) {
  // FINE: groups other than 32 or 64 rows, whole K tiles or all of K (those
  // that end inside a 32-deep k step, and 96, 160, ...), K tiles of other
  // than KT rows (pack blocks that do not divide KT), pack blocks of fewer
  // than four word rows a plane, or x that TMA cannot address. It runs its
  // one tile whatever instantiated tile (bm, bn) names.
  const bool fine = !(g == K || g == KSTEP || g == 2 * KSTEP || g % KT == 0) ||
                    tile_rows(pb) != KT || (pb / Packing<BITS>::PER) % 4 != 0 || K % 16 != 0 ||
                    !aligned16(xq);
  auto run_fine = [&]() {
    if (sym) return run_a8<BITS, true, true, A8_BM, A8_BN>(dtype, xq, xs, qw, s, z, out, M, K, N, pb, g, stream);
    return run_a8<BITS, false, true, A8_BM, A8_BN>(dtype, xq, xs, qw, s, z, out, M, K, N, pb, g, stream);
  };
#define SAMQ_A8(TBM, TBN)                                                                       \
  if (bm == TBM && bn == TBN) {                                                                 \
    if (fine) return run_fine();                                                                \
    if (sym)                                                                                    \
      return run_a8<BITS, true, false, TBM, TBN>(dtype, xq, xs, qw, s, z, out, M, K, N, pb, g,  \
                                                 stream);                                       \
    return run_a8<BITS, false, false, TBM, TBN>(dtype, xq, xs, qw, s, z, out, M, K, N, pb, g,   \
                                                stream);                                        \
  }
  // The main build's tiles (ops/autotune.py's TILES_A8), the default first.
  SAMQ_A8(128, 128)
  SAMQ_A8(256, 128)
  SAMQ_A8(256, 64)
#undef SAMQ_A8
  return (int)cudaErrorInvalidValue;  // not an instantiated tile
}

}  // namespace samq_quant

// dtype (of out): 0 float32, 1 bfloat16. bits 2, 4 or 8; sym: 1 for the
// symmetric kernel (zeros unused, may be null), 0 for the asymmetric one.
// xq int8 (M, K), xs float32 (M,). The tile: bm x bn outputs a block, one
// of 128 x 128, 256 x 128, 256 x 64, and bk K rows a tile, which must be
// tile_rows(pack_block); a layout that takes the FINE build runs its one
// 128 x 128 tile. A tile that is not instantiated returns
// cudaErrorInvalidValue; it is not rounded to another. Returns the CUDA
// error of the launch (0 on success).
extern "C" int samq_quant_matmul_a8(int dtype, int bits, int sym, const void* xq, const void* xs,
                                    const void* qweight, const void* scales, const void* zeros,
                                    void* out, int M, int K, int N, int groupsize, int pack_block,
                                    int bm, int bn, int bk, void* stream) {
  using namespace samq_quant;
  if ((dtype != 0 && dtype != 1) || M < 1 || (bits != 2 && bits != 4 && bits != 8) ||
      bn < 1 || (N + bn - 1) / bn > 65535 ||
      !packing_ok(bits, K, N, pack_block, groupsize) || bk != tile_rows(pack_block) ||
      (!sym && zeros == nullptr))
    return (int)cudaErrorInvalidValue;
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* xsf = static_cast<const float*>(xs);
  const int32_t* qw = static_cast<const int32_t*>(qweight);
  const float* s = static_cast<const float*>(scales);
  const float* z = static_cast<const float*>(zeros);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SAMQ_RUN(B) \
  run_a8_bits<B>(dtype, sym, x8, xsf, qw, s, z, out, M, K, N, pack_block, groupsize, bm, bn, st)
  switch (bits) {
    case 2: return SAMQ_RUN(2);
    case 4: return SAMQ_RUN(4);
    default: return SAMQ_RUN(8);
  }
#undef SAMQ_RUN
}
