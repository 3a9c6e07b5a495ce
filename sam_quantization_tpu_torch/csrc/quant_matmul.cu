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
// Design: bfloat16 runs the tensor-core body of qmm_tc.cuh (wgmma products,
// the weight decode overlapped with them; its note has the layout and the
// arithmetic). float32 inputs take a CUDA-core FMA path: one block owns a
// (64, 64) output tile and walks K in tiles of whole pack blocks
// (tile_rows), staged in shared memory without a pipeline. Every block
// dequantizes the weight columns it needs, so the weights are unpacked
// M / 256 (bf16) or M / 64 (f32) times in all.
#include "qmm_tc.cuh"

namespace samq_quant {

constexpr int THREADS = 256;

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

  const int kt = tile_rows(pb);
  for (int k0 = 0; k0 < K; k0 += kt) {
    __syncthreads();
    fill_x_tile<float, FBM, KT, THREADS>(Xs, FXLD, x, m0, M, k0, K, kt, vec);
    fill_weight_tile<float, BITS, FBN, THREADS>(Ws, FBN, qw, qw_hi, scales, zeros, k0, K, n0, N,
                                                pb, groupsize, kt);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kt; ++kk) {
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
  if (dtype == 1)
    return tc::run<BITS, tc::PLAIN>(static_cast<const __nv_bfloat16*>(x), qw, qw_hi, s, z,
                                    nullptr, static_cast<__nv_bfloat16*>(out), M, K, N, pb, g,
                                    stream);
  const dim3 grid((M + FBM - 1) / FBM, (N + FBN - 1) / FBN);
  return launch(qmm_f32_kernel<BITS>, grid, THREADS, F32_SMEM, stream,
                static_cast<const float*>(x), qw, qw_hi, s, z, static_cast<float*>(out), M, K,
                N, pb, g, vec_ok(x, K, tile_rows(pb), 4));
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
