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
// operations.
//
// Design (a simple first version): one block of 8 warps owns a (128, 128)
// output tile and walks K in tiles of whole pack blocks (at most 128 rows,
// zero-padded to whole 32-deep k steps). Per tile the int8 x tile arrives by
// cp.async (value by value where a tile does not start on a 16-byte
// boundary of an x row) and the packed words
// are decoded, as w - mid or w - off (subtracted before the narrowing, so a
// grid value of 255 never wraps), into an int8 [n][k] tile: a thread takes
// four word rows of one column and writes each plane's four consecutive k
// as one 32-bit word (byte by byte where a pack block's planes are not
// multiples of 4 rows). Both tiles are double-buffered as in quant_matmul.cu.
// Each warp owns a 32 x 64 sub-tile and runs
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 on the int8 tensor cores; its
// int32 sums cover one segment and are folded into float32 accumulators in
// registers at the segment's end (the accumulator layout of m16n8k32 is
// documented, so s_g[n], z_g[n] and the row's rowsum apply per register).
// The asymmetric rowsum comes from the A fragments the warp already holds
// (dp4a of each register with 0x01010101, then two shuffles across the four
// lanes of a row).
// A group that ends inside a 32-deep k step (groupsize % 32 != 0; the
// packing makes it a multiple of 4, and each A register holds 4 consecutive
// k), or K tiles of other than 128 rows (pack blocks that do not divide
// 128: tile_rows), take the FINE instantiation: the step runs once per
// segment it holds, with the A registers outside the segment zeroed, and
// each segment reads its own scale (and zero) from device memory when it
// is folded. The segments and their float32 order are the same as above.
#include "quant_common.cuh"

namespace samq_quant {

constexpr int A8_BM = 128, A8_BN = 128;
constexpr int A8_THREADS = 256;     // 8 warps, 4 (M) x 2 (N), each a 32 x 64 sub-tile
constexpr int A8_LD = KT + 16;      // int8 row pitch: 144 B = 36 words, fragment loads conflict-free
constexpr int KSTEP = 32;           // k of one mma.m16n8k32
constexpr int KSTEPS = KT / KSTEP;  // most k steps of a K tile
constexpr size_t A8_BUF = (size_t)(A8_BM + A8_BN) * A8_LD + 2 * KSTEPS * A8_BN * sizeof(float);
constexpr size_t A8_SMEM = 2 * A8_BUF;

template <int BITS, bool SYM>
constexpr int a8_sub() {
  return SYM ? 1 << (BITS - 1) : (BITS == 8 ? 128 : 0);
}

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

template <int BITS, bool SYM, bool FINE, typename T>
__global__ void __launch_bounds__(A8_THREADS, 1)
    qmm_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int32_t* __restrict__ qw, const float* __restrict__ scales,
                  const float* __restrict__ zeros, T* __restrict__ out, int M, int K, int N,
                  int pb, int groupsize, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);             // 2 x BM x LD
  int8_t* Ws = Xs + 2 * A8_BM * A8_LD;                        // 2 x BN x LD
  float* Ss = reinterpret_cast<float*>(Ws + 2 * A8_BN * A8_LD);  // 2 x KSTEPS x BN
  float* Zs = Ss + 2 * KSTEPS * A8_BN;                        // 2 x KSTEPS x BN
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the mma fragments' row group and lane in it
  const int m0 = blockIdx.x * A8_BM, n0 = blockIdx.y * A8_BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  // The FINE build takes any K tile; the other one tiles of KT rows (pack
  // blocks that divide KT), compile-time constants.
  const int kt = FINE ? tile_rows(pb) : KT, ksteps = (kt + KSTEP - 1) / KSTEP;
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
  if constexpr (FINE) {
    for (int i = threadIdx.x; i < 2 * A8_BN * (ksteps * KSTEP - kt); i += A8_THREADS) {
      const int b = i / (A8_BN * (ksteps * KSTEP - kt)), j = i % (A8_BN * (ksteps * KSTEP - kt));
      Ws[b * A8_BN * A8_LD + (j % A8_BN) * A8_LD + kt + j / A8_BN] = 0;
    }
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
    const float* st = Ss + cur * KSTEPS * A8_BN;
    const float* zt = Zs + cur * KSTEPS * A8_BN;
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
      if constexpr (!FINE) {
        step(a);
        // End of a segment: the last k step of the tile, of K, or of a group.
        if (ks == ksteps - 1 || k + KSTEP >= K || (k + KSTEP) % groupsize == 0)
          fold([&](int c, float& s, float& zr) {
            s = st[ks * A8_BN + c];
            if constexpr (!SYM) zr = zt[ks * A8_BN + c];
          });
      } else {
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

template <int BITS, bool SYM, bool FINE>
static int run_a8(int dtype, const int8_t* xq, const float* xs, const int32_t* qw,
                  const float* s, const float* z, void* out, int M, int K, int N, int pb, int g,
                  cudaStream_t stream) {
  const dim3 grid((M + A8_BM - 1) / A8_BM, (N + A8_BN - 1) / A8_BN);
  const bool vec = vec_ok(xq, K, tile_rows(pb), 16);
  if (dtype == 1)
    return launch(qmm_a8_kernel<BITS, SYM, FINE, __nv_bfloat16>, grid, A8_THREADS, A8_SMEM,
                  stream, xq, xs, qw, s, z, static_cast<__nv_bfloat16*>(out), M, K, N, pb, g, vec);
  return launch(qmm_a8_kernel<BITS, SYM, FINE, float>, grid, A8_THREADS, A8_SMEM, stream, xq, xs,
                qw, s, z, static_cast<float*>(out), M, K, N, pb, g, vec);
}

template <int BITS>
static int run_a8_bits(int dtype, int sym, const int8_t* xq, const float* xs, const int32_t* qw,
                       const float* s, const float* z, void* out, int M, int K, int N, int pb,
                       int g, cudaStream_t stream) {
  // FINE: a group ends inside a 32-deep k step, or the K tiles are not KT
  // rows (pack blocks that do not divide KT).
  const bool fine = (g != K && g % KSTEP != 0) || tile_rows(pb) != KT;
  if (sym) {
    if (fine) return run_a8<BITS, true, true>(dtype, xq, xs, qw, s, z, out, M, K, N, pb, g, stream);
    return run_a8<BITS, true, false>(dtype, xq, xs, qw, s, z, out, M, K, N, pb, g, stream);
  }
  if (fine) return run_a8<BITS, false, true>(dtype, xq, xs, qw, s, z, out, M, K, N, pb, g, stream);
  return run_a8<BITS, false, false>(dtype, xq, xs, qw, s, z, out, M, K, N, pb, g, stream);
}

}  // namespace samq_quant

// dtype (of out): 0 float32, 1 bfloat16. bits 2, 4 or 8; sym: 1 for the
// symmetric kernel (zeros unused, may be null), 0 for the asymmetric one.
// xq int8 (M, K), xs float32 (M,). Returns the CUDA error of the launch (0 on
// success).
extern "C" int samq_quant_matmul_a8(int dtype, int bits, int sym, const void* xq, const void* xs,
                                    const void* qweight, const void* scales, const void* zeros,
                                    void* out, int M, int K, int N, int groupsize, int pack_block,
                                    void* stream) {
  using namespace samq_quant;
  if ((dtype != 0 && dtype != 1) || M < 1 || (bits != 2 && bits != 4 && bits != 8) ||
      N > 65535 * A8_BN || !packing_ok(bits, K, N, pack_block, groupsize) ||
      (!sym && zeros == nullptr))
    return (int)cudaErrorInvalidValue;
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* xsf = static_cast<const float*>(xs);
  const int32_t* qw = static_cast<const int32_t*>(qweight);
  const float* s = static_cast<const float*>(scales);
  const float* z = static_cast<const float*>(zeros);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return run_a8_bits<2>(dtype, sym, x8, xsf, qw, s, z, out, M, K, N, pack_block, groupsize, st);
    case 4: return run_a8_bits<4>(dtype, sym, x8, xsf, qw, s, z, out, M, K, N, pack_block, groupsize, st);
    default: return run_a8_bits<8>(dtype, sym, x8, xsf, qw, s, z, out, M, K, N, pack_block, groupsize, st);
  }
}
