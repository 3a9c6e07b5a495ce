// Fused quantized MLP: out (M, N) = round(gelu_tanh(x @ W1 + b1)) @ W2, both
// weights block-planar packed with the same bit width (2, 4 or 8), float32
// accumulation, output in x's type. b2 is added outside the kernel.
//
// Replaces: sam_quantization_tpu/ops/fused_mlp.py::_fused_mlp_kernel (:28-49),
// launched by _fused_mlp_call (:56-91) through fused_mlp (:129-176). Same
// function, same order: a = x @ dequant(W1)[:, tile] + b1 in float32,
// h = gelu_tanh(a) in float32 rounded to x's type, acc += h @ dequant(W2)[tile]
// in float32 over hidden tiles of 512; the (M, H) hidden activation never
// reaches device memory (42 MB written and read per block at ViT-H in bf16).
//
// What bounds it on an H100: at ViT-H (M 4096, K = N 1280, H 5120, 4-bit)
// the two products are 107.4 GFLOP against ~22 MB moved: 109 us of bf16
// tensor-core time against 7 us of memory, so it is bound by operations.
//
// The trap: the TPU kernel keeps a (256, N) float32 accumulator in VMEM
// (1.3 MB at N 1280); a Hopper block has 227 KB. Design (bfloat16): a block
// owns 32 rows and up to 1280 output columns (wider N takes more column
// groups on grid.y, each recomputing the hidden tiles). Its (32, 1280)
// float32 accumulator lives in dynamic shared memory (160 KB) next to one
// (32, 512) bf16 hidden tile and one (128, 128) bf16 weight tile: 227 KB,
// the whole of what a block may have; M 4096 gives 128 blocks for 132 SMs.
// Per hidden tile, phase 1 walks K in tiles of 128 rows (whole pack blocks,
// dequantized word by word, quant_common.cuh), with two x tiles (cp.async)
// in the hidden tile's buffer, and runs x @ W1 on the tensor cores (wmma
// bf16, 16 warps, each a (16, 16) piece of each of the four 128-column
// sub-tiles, float32 fragments in registers); then it adds b1, applies the
// GELU and stores the rounded hidden tile. Phase 2 adds h @ W2 into the
// shared accumulator, one (32, 128) column chunk at a time, streaming
// (128, 128) W2 tiles. The packed words of the next weight tile are loaded
// into registers before the current tile is multiplied, so their latency
// hides behind the products; the decode itself does not overlap them (there
// is room for one weight buffer only). Sums run in a fixed order, with no
// atomics, so every run gives the same bits. Recomputing the hidden tile for
// each output column tile would fit a smaller accumulator but repeat the
// first product N / 128 times; this design repeats only the weight unpack,
// once per 32-row block (M / 32 times in all). That decode, between two
// barriers per tile with one block per SM, is what holds this first version
// back, ahead of the products themselves. float32 takes a
// CUDA-core path: 16 rows per block, hidden sub-tiles of 128 in shared
// memory, the (16, 1280) accumulator in registers (5 columns of 16 rows per
// thread).
#include <mma.h>

#include "quant_common.cuh"

namespace samq_quant {

using namespace nvcuda;

constexpr int HT = 512;       // hidden tile (the TPU kernel's block_h)
constexpr int MAX_GW = 1280;  // output columns per block; wider N takes more groups

__device__ __forceinline__ float gelu_tanh(float a) {
  // jax.nn.gelu(approximate=True): a * (0.5 * (1 + tanh(sqrt(2/pi) * (a + 0.044715 a^3)))),
  // each operation rounded on its own as XLA does (no FMA contraction).
  const float a3 = __fmul_rn(__fmul_rn(a, a), a);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(a, __fmul_rn(0.044715f, a3)));
  return __fmul_rn(a, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// ----------------------------------------------------------------- bfloat16
constexpr int BM = 32;   // rows per block
constexpr int BT = 512;  // threads: 16 warps, each a (16, 16) piece of every (32, 128) tile
constexpr int CW = 128;  // columns of a weight tile (KT rows x CW)
constexpr int HLD = HT + 8, WLD = CW + 8, XLD = KT + 8;  // bf16 pitches, 16 B multiples

inline size_t bf16_smem_bytes(int gw) {
  return (size_t)BM * (gw + 4) * sizeof(float) + (size_t)BM * HLD * 2 + (size_t)KT * WLD * 2;
}

template <int BITS, int PB>
__global__ void __launch_bounds__(BT, 1)
    fused_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ qw1,
                          const float* __restrict__ s1, const float* __restrict__ z1,
                          const float* __restrict__ b1, const int32_t* __restrict__ qw2,
                          const float* __restrict__ s2, const float* __restrict__ z2,
                          __nv_bfloat16* __restrict__ out, int M, int K, int H, int N, int g1,
                          int pb1, int g2, int pb2, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ALD = min(N, MAX_GW) + 4;
  float* acc = reinterpret_cast<float*>(smem);                             // BM x ALD
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(acc + BM * ALD);  // BM x HLD
  __nv_bfloat16* wbuf = hbuf + BM * HLD;                                   // KT x WLD
  // While a hidden tile is computed, hbuf holds two (BM, XLD) x tiles instead.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * MAX_GW, gw = min(MAX_GW, N - c0);
  const int rf = (warp >> 3) * 16, cf = (warp & 7) * 16;  // the warp's piece of a (32, 128) tile
  const int ktiles = (K + KT - 1) / KT;
  // Each weight tile's words are loaded into registers one step ahead and
  // are in flight while the previous tile is multiplied.
  WeightTile<BITS, CW, BT, PB> wt;

  for (int i = threadIdx.x; i < BM * ALD; i += BT) acc[i] = 0.f;

  for (int h0 = 0; h0 < H; h0 += HT) {
    // Phase 1: a (32, 512) = x @ W1[:, h0:h0+512], as four 128-column sub-tiles.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> a[HT / CW];
#pragma unroll
    for (int j = 0; j < HT / CW; ++j) wmma::fill_fragment(a[j], 0.f);
    wt.load(qw1, nullptr, s1, z1, 0, K, h0, H, pb1, g1);
    __syncthreads();  // the previous hidden tile is consumed: hbuf takes x
    copy_x_tile_async<__nv_bfloat16, BM, KT, BT>(hbuf, XLD, x, m0, M, 0, K, vec);
    for (int kt = 0; kt < ktiles; ++kt) {
      const __nv_bfloat16* xc = hbuf + (kt & 1) * BM * XLD;
#pragma unroll
      for (int j = 0; j < HT / CW; ++j) {
        if (j == 0) cp_async_wait_all();
        __syncthreads();  // x of this K tile is in place; the previous products are done
        wt.store(wbuf, WLD);
        __syncthreads();
        if (j + 1 < HT / CW) {
          wt.load(qw1, nullptr, s1, z1, kt * KT, K, h0 + (j + 1) * CW, H, pb1, g1);
        } else if (kt + 1 < ktiles) {
          copy_x_tile_async<__nv_bfloat16, BM, KT, BT>(hbuf + ((kt + 1) & 1) * BM * XLD,
                                                            XLD, x, m0, M, (kt + 1) * KT, K, vec);
          wt.load(qw1, nullptr, s1, z1, (kt + 1) * KT, K, h0, H, pb1, g1);
        }
#pragma unroll 2
        for (int kk = 0; kk < KT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, xc + rf * XLD + kk, XLD);
          wmma::load_matrix_sync(fb, wbuf + kk * WLD + cf, WLD);
          wmma::mma_sync(a[j], fa, fb, a[j]);
        }
      }
    }
    wt.load(qw2, nullptr, s2, z2, h0, H, c0, N, pb2, g2);  // phase 2's first tile
    __syncthreads();  // every warp is done with x and W1: hbuf takes h, wbuf stages
    // h = round(gelu_tanh(a + b1)), staged through the warp's own 1 KB of wbuf.
    float* stage = reinterpret_cast<float*>(wbuf) + warp * 256;
#pragma unroll
    for (int j = 0; j < HT / CW; ++j) {
      wmma::store_matrix_sync(stage, a[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rf + (e >> 4), c = j * CW + cf + (e & 15);
        hbuf[r * HLD + c] = __float2bfloat16(gelu_tanh(__fadd_rn(stage[e], __ldg(b1 + h0 + c))));
      }
      __syncwarp();
    }

    // Phase 2: acc (32, gw) += h @ W2[h0:h0+512, c0:c0+gw], one 128-column chunk at a time.
    for (int n0 = 0; n0 < gw; n0 += CW) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, acc + rf * ALD + n0 + cf, ALD, wmma::mem_row_major);
#pragma unroll
      for (int hs = 0; hs < HT / KT; ++hs) {
        __syncthreads();  // h is complete; the previous W2 tile (or the staging) is consumed
        wt.store(wbuf, WLD);
        __syncthreads();
        if (hs + 1 < HT / KT)
          wt.load(qw2, nullptr, s2, z2, h0 + (hs + 1) * KT, H, c0 + n0, N, pb2, g2);
        else if (n0 + CW < gw)
          wt.load(qw2, nullptr, s2, z2, h0, H, c0 + n0 + CW, N, pb2, g2);
#pragma unroll 2
        for (int kk = 0; kk < KT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, hbuf + rf * HLD + hs * KT + kk, HLD);
          wmma::load_matrix_sync(fb, wbuf + kk * WLD + cf, WLD);
          wmma::mma_sync(c, fa, fb, c);
        }
      }
      wmma::store_matrix_sync(acc + rf * ALD + n0 + cf, c, ALD, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * gw; i += BT) {
    const int r = i / gw, n = i - r * gw, m = m0 + r;
    if (m < M) out[(long)m * N + c0 + n] = __float2bfloat16(acc[r * ALD + n]);
  }
}

// ------------------------------------------------------------------ float32
constexpr int THREADS = 256;
constexpr int FBM = 16;               // rows per block
constexpr int FHT = 128;              // hidden sub-tile
constexpr int FNJ = MAX_GW / THREADS;  // output columns per thread: tid + 256 j
constexpr int FXLD = KT + 4;          // float pitch of the x tile (16-byte rows)
constexpr size_t F32_SMEM =
    ((size_t)KT * THREADS + (size_t)FBM * FXLD + (size_t)FBM * FHT) * sizeof(float);

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    fused_mlp_f32_kernel(const float* __restrict__ x, const int32_t* __restrict__ qw1,
                         const float* __restrict__ s1, const float* __restrict__ z1,
                         const float* __restrict__ b1, const int32_t* __restrict__ qw2,
                         const float* __restrict__ s2, const float* __restrict__ z2,
                         float* __restrict__ out, int M, int K, int H, int N, int g1, int pb1,
                         int g2, int pb2, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* wbuf = reinterpret_cast<float*>(smem);  // KT x FHT (W1) or KT x THREADS (W2)
  float* xs = wbuf + KT * THREADS;               // FBM x FXLD
  float* hs = xs + FBM * FXLD;                   // FBM x FHT
  const int tid = threadIdx.x, c = tid & (FHT - 1), r0 = (tid / FHT) * (FBM / 2);
  const int m0 = blockIdx.x * FBM, c0 = blockIdx.y * MAX_GW, gw = min(MAX_GW, N - c0);
  float acc[FBM][FNJ];
#pragma unroll
  for (int r = 0; r < FBM; ++r)
#pragma unroll
    for (int j = 0; j < FNJ; ++j) acc[r][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += FHT) {
    // Phase 1: thread (r0, c) computes a[r0 + r, c] for 8 rows.
    float a[FBM / 2];
#pragma unroll
    for (int r = 0; r < FBM / 2; ++r) a[r] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KT) {
      __syncthreads();  // the previous tiles are consumed
      fill_x_tile<float, FBM, KT, THREADS>(xs, FXLD, x, m0, M, k0, K, vec);
      fill_weight_tile<float, BITS, FHT, THREADS>(wbuf, FHT, qw1, nullptr, s1, z1, k0, K, h0, H,
                                                  pb1, g1);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        const float w = wbuf[kk * FHT + c];
#pragma unroll
        for (int r = 0; r < FBM / 2; ++r) a[r] = fmaf(xs[(r0 + r) * FXLD + kk], w, a[r]);
      }
    }
    const float bias = __ldg(b1 + h0 + c);
#pragma unroll
    for (int r = 0; r < FBM / 2; ++r) hs[(r0 + r) * FHT + c] = gelu_tanh(__fadd_rn(a[r], bias));

    // Phase 2: acc[r][j] += h[r, :] @ W2[h0:h0+128, c0 + tid + 256 j].
#pragma unroll
    for (int j = 0; j < FNJ; ++j) {
      if (j * THREADS >= gw) break;
      __syncthreads();  // h is complete; the previous W2 tile is consumed
      fill_weight_tile<float, BITS, THREADS, THREADS>(wbuf, THREADS, qw2, nullptr, s2, z2, h0, H,
                                                      c0 + j * THREADS, N, pb2, g2);
      __syncthreads();
#pragma unroll 4
      for (int hh = 0; hh < FHT; ++hh) {
        const float w = wbuf[hh * THREADS + tid];
#pragma unroll
        for (int r = 0; r < FBM; ++r) acc[r][j] = fmaf(hs[r * FHT + hh], w, acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < FNJ; ++j) {
    const int n = j * THREADS + tid;
    if (n >= gw) continue;
#pragma unroll
    for (int r = 0; r < FBM; ++r)
      if (m0 + r < M) out[(long)(m0 + r) * N + c0 + n] = acc[r][j];
  }
}

template <int BITS>
static int run(int dtype, const void* x, const int32_t* w1, const float* s1, const float* z1,
               const float* b1, const int32_t* w2, const float* s2, const float* z2, void* out,
               int M, int K, int H, int N, int g1, int pb1, int g2, int pb2, cudaStream_t st) {
  const int groups = (N + MAX_GW - 1) / MAX_GW;
  if (dtype == 1)
    // Pack blocks of 128 rows in both weights (the default at every ViT width) are compiled in.
    return launch(pb1 == KT && pb2 == KT ? fused_mlp_bf16_kernel<BITS, KT>
                                         : fused_mlp_bf16_kernel<BITS, 0>,
                  dim3((M + BM - 1) / BM, groups), BT,
                  bf16_smem_bytes(N < MAX_GW ? N : MAX_GW), st,
                  static_cast<const __nv_bfloat16*>(x), w1,
                  s1, z1, b1, w2, s2, z2, static_cast<__nv_bfloat16*>(out), M, K, H, N, g1, pb1,
                  g2, pb2, vec_ok(x, K, 8));
  return launch(fused_mlp_f32_kernel<BITS>, dim3((M + FBM - 1) / FBM, groups), THREADS, F32_SMEM,
                st, static_cast<const float*>(x), w1, s1, z1, b1, w2, s2, z2,
                static_cast<float*>(out), M, K, H, N, g1, pb1, g2, pb2, vec_ok(x, K, 4));
}

}  // namespace samq_quant

// dtype: 0 float32, 1 bfloat16. Both weights have `bits` in (2, 4, 8); H a
// multiple of 512 and N of 128 (fused_mlp_supported); b1 is float32 (H,)
// (zeros for no bias). Returns the CUDA error of the launch (0 on success).
extern "C" int samq_fused_mlp(int dtype, int bits, const void* x, const void* qw1,
                              const void* s1, const void* z1, const void* b1, const void* qw2,
                              const void* s2, const void* z2, void* out, int M, int K, int H,
                              int N, int g1, int pb1, int g2, int pb2, void* stream) {
  using namespace samq_quant;
  if ((dtype != 0 && dtype != 1) || M < 1 || bits == 3 || H % HT || N % CW ||
      !packing_ok(bits, K, H, pb1, g1) || !packing_ok(bits, H, N, pb2, g2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* w1 = static_cast<const int32_t*>(qw1);
  const int32_t* w2 = static_cast<const int32_t*>(qw2);
  const float *fs1 = static_cast<const float*>(s1), *fz1 = static_cast<const float*>(z1);
  const float *fs2 = static_cast<const float*>(s2), *fz2 = static_cast<const float*>(z2);
  const float* fb1 = static_cast<const float*>(b1);
#define SAMQ_RUN(B) \
  run<B>(dtype, x, w1, fs1, fz1, fb1, w2, fs2, fz2, out, M, K, H, N, g1, pb1, g2, pb2, st)
  switch (bits) {
    case 2: return SAMQ_RUN(2);
    case 4: return SAMQ_RUN(4);
    default: return SAMQ_RUN(8);
  }
#undef SAMQ_RUN
}
