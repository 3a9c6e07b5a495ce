// Weight-only dequant-matmul on block-planar packed weights:
// out (M, N) = x (M, K) @ ((unpack(qweight) - z[k / g]) * s[k / g]), float32
// accumulation, output in x's type.
//
// Replaces: sam_quantization_tpu/ops/quant_matmul.py::_qmm_kernel (:223-241,
// bits 2/4/8) and ::_qmm_kernel3 (:244-262, split-plane 3-bit), launched by
// _qmm_call (:525-584) through quant_matmul_pallas (:607-640). It computes
// the same function: each weight tile is unpacked with shift and mask,
// dequantized in float32, rounded to the working type, and multiplied with
// float32 accumulation. The TPU wrapper's M padding and its replication of
// scale rows to a (num_k, groups_per_bk, N) array exist because Mosaic cannot
// slice thin rows; here ragged M and N are masked and scales are indexed by
// k / groupsize, so every shape is taken.
//
// What bounds it on an H100: at ViT-H (qkv: M 4900, K 1280, N 3840, 4-bit,
// g 128) the product is 48.2 GFLOP against ~53 MB moved (bf16 x 12.5 MB,
// out 37.6 MB, packed weights with scales and zeros 2.8 MB): 49 us of bf16
// tensor-core time against 16 us of memory, so it is bound by operations.
//
// Design: one block owns a (128, 128) output tile and walks K in tiles of 128
// rows, a whole number of pack blocks (the TPU's sequential K grid axis
// becomes a loop inside the block). Per tile it stages x (cp.async) and the
// weight tile, dequantized word by word (quant_common.cuh), in shared
// memory, and runs the bfloat16 product on the tensor cores (wmma 16x16x16,
// float32 accumulators in registers; 16 warps, each a 32x32 sub-tile). Both
// tiles are double-buffered (136 KB): while a step multiplies tile t, the
// x copy of tile t + 1 and the weight loads of tile t + 2 are in flight, and
// the decode of tile t + 1 can run on one warp while another multiplies.
// float32 inputs take a CUDA-core FMA path with (64, 64) tiles staged
// without a pipeline. Every block dequantizes the weight columns it needs,
// so the weights are unpacked M / 128 times in all.
#include <mma.h>

#include "quant_common.cuh"

namespace samq_quant {

using namespace nvcuda;

constexpr int THREADS = 256;

// ----------------------------------------------------------------- bfloat16
constexpr int BM = 128, BN = 128;
constexpr int BT = 512;  // threads: 16 warps, each a 32x32 sub-tile
constexpr int LD = KT + 8;  // bf16 row pitch of all tiles: 272 B rows keep wmma pointers aligned
constexpr size_t BF16_SMEM = 2 * (size_t)(BM + KT) * LD * sizeof(__nv_bfloat16);

template <int BITS>
__global__ void __launch_bounds__(BT, 1)
    qmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ qw,
                    const int32_t* __restrict__ qw_hi, const float* __restrict__ scales,
                    const float* __restrict__ zeros, __nv_bfloat16* __restrict__ out, int M,
                    int K, int N, int pb, int groupsize, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 x BM x LD
  __nv_bfloat16* Ws = Xs + 2 * BM * LD;                          // 2 x KT x LD
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int tiles = (K + KT - 1) / KT;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Tile t's x and weights sit in buffer t % 2. Tile 0 is staged first; in
  // step t each thread copies x of tile t + 1, decodes tile t + 1's words
  // (loaded into registers during step t - 1), issues the loads of tile
  // t + 2, and only then multiplies tile t, so the loads are in flight
  // during the products.
  WeightTile<BITS, BN, BT, 0> wt;  // pack block read at run time (see the header)
  copy_x_tile_async<__nv_bfloat16, BM, KT, BT>(Xs, LD, x, m0, M, 0, K, vec);
  wt.load(qw, qw_hi, scales, zeros, 0, K, n0, N, pb, groupsize);
  wt.store(Ws, LD);
  if (tiles > 1) wt.load(qw, qw_hi, scales, zeros, KT, K, n0, N, pb, groupsize);
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in place; step t - 1's products are done with buffer nxt
    if (t + 1 < tiles) {
      copy_x_tile_async<__nv_bfloat16, BM, KT, BT>(Xs + nxt * BM * LD, LD, x, m0, M,
                                                   (t + 1) * KT, K, vec);
      wt.store(Ws + nxt * KT * LD, LD);
      if (t + 2 < tiles) wt.load(qw, qw_hi, scales, zeros, (t + 2) * KT, K, n0, N, pb, groupsize);
    }
    const __nv_bfloat16* xt = Xs + cur * BM * LD;
    const __nv_bfloat16* wt_s = Ws + cur * KT * LD;
#pragma unroll 2
    for (int kk = 0; kk < KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xt + (wm + 16 * i) * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], wt_s + kk * LD + wn + 16 * j, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // Epilogue: each warp stages one 16x16 fragment at a time in its own 1 KB
  // of the (now free) x tile and writes the in-range part.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(Xs) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm + 16 * i + (e >> 4), n = n0 + wn + 16 * j + (e & 15);
        if (m < M && n < N) out[(long)m * N + n] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
}

// ------------------------------------------------------------------ float32
constexpr int FBM = 64, FBN = 64;
constexpr int FXLD = KT + 4;  // float pitch of the x tile: 16-byte rows, rows 4 banks apart
constexpr size_t F32_SMEM = ((size_t)FBM * FXLD + (size_t)KT * FBN) * sizeof(float);

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    qmm_f32_kernel(const float* __restrict__ x, const int32_t* __restrict__ qw,
                   const int32_t* __restrict__ qw_hi, const float* __restrict__ scales,
                   const float* __restrict__ zeros, float* __restrict__ out, int M, int K, int N,
                   int pb, int groupsize, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);  // FBM x FXLD
  float* Ws = Xs + FBM * FXLD;                 // KT x FBN
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
    fill_x_tile<float, FBM, KT, THREADS>(Xs, FXLD, x, m0, M, k0, K, vec);
    fill_weight_tile<float, BITS, FBN, THREADS>(Ws, FBN, qw, qw_hi, scales, zeros, k0, K, n0, N,
                                                pb, groupsize);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[(ty + 16 * i) * FXLD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk * FBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) out[(long)m * N + n] = acc[i][j];
    }
}

template <int BITS>
static int run(int dtype, const void* x, const int32_t* qw, const int32_t* qw_hi,
               const float* s, const float* z, void* out, int M, int K, int N, int pb, int g,
               cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    return launch(qmm_bf16_kernel<BITS>, grid, BT, BF16_SMEM, stream,
                  static_cast<const __nv_bfloat16*>(x), qw, qw_hi, s, z,
                  static_cast<__nv_bfloat16*>(out), M, K, N, pb, g, vec_ok(x, K, 8));
  }
  const dim3 grid((M + FBM - 1) / FBM, (N + FBN - 1) / FBN);
  return launch(qmm_f32_kernel<BITS>, grid, THREADS, F32_SMEM, stream,
                static_cast<const float*>(x), qw, qw_hi, s, z, static_cast<float*>(out), M, K,
                N, pb, g, vec_ok(x, K, 4));
}

}  // namespace samq_quant

// dtype: 0 float32, 1 bfloat16. bits 2, 4, 8, or 3 with qweight_hi.
// Returns the CUDA error of the launch (0 on success).
extern "C" int samq_quant_matmul(int dtype, int bits, const void* x, const void* qweight,
                                 const void* qweight_hi, const void* scales, const void* zeros,
                                 void* out, int M, int K, int N, int groupsize, int pack_block,
                                 void* stream) {
  using namespace samq_quant;
  if ((dtype != 0 && dtype != 1) || M < 1 || N > 65535 * FBN ||
      !packing_ok(bits, K, N, pack_block, groupsize) || (bits == 3 && qweight_hi == nullptr))
    return (int)cudaErrorInvalidValue;
  const int32_t* qw = static_cast<const int32_t*>(qweight);
  const int32_t* qh = static_cast<const int32_t*>(qweight_hi);
  const float* s = static_cast<const float*>(scales);
  const float* z = static_cast<const float*>(zeros);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return run<2>(dtype, x, qw, qh, s, z, out, M, K, N, pack_block, groupsize, st);
    case 3: return run<3>(dtype, x, qw, qh, s, z, out, M, K, N, pack_block, groupsize, st);
    case 4: return run<4>(dtype, x, qw, qh, s, z, out, M, K, N, pack_block, groupsize, st);
    default: return run<8>(dtype, x, qw, qh, s, z, out, M, K, N, pack_block, groupsize, st);
  }
}
