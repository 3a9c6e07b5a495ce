// Fused quantized MLP: out (M, N) = round(gelu_tanh(x @ W1 + b1)) @ W2, both
// weights block-planar packed with the same bit width (2, 4 or 8), float32
// accumulation, output in x's type. b2 is added outside the kernel.
//
// Replaces: sam_quantization_tpu/ops/fused_mlp.py::_fused_mlp_kernel (:28-49),
// launched by _fused_mlp_call (:56-91) through fused_mlp (:129-176). Same
// function, same order: a = x @ dequant(W1) + b1 in float32, h =
// gelu_tanh(a) in float32 rounded to x's type, out = h @ dequant(W2) summed
// in float32 and rounded to x's type. The TPU kernel keeps h in VMEM, one
// hidden tile of 512 at a time; here the bfloat16 path passes it through
// device memory between two launches (below), the float32 path keeps it in
// shared memory.
//
// What bounds it on an H100: at ViT-H (M 4096, K = N 1280, H 5120, 4-bit)
// the two products are 107.4 GFLOP against ~22 MB moved: 109 us of bf16
// tensor-core time against 7 us of memory, so it is bound by operations.
//
// The trap: the TPU kernel keeps a (256, N) float32 accumulator in VMEM
// (1.3 MB at N 1280); a Hopper SM has 227 KB of shared memory and 256 KB of
// registers, and a (64, 1280) float32 sum alone is 320 KB. Design
// (bfloat16): two launches of the tensor-core body of qmm_tc.cuh, the first
// x @ W1 with the +b1 -> gelu_tanh -> round epilogue into h (M, H) bf16, a
// scratch tensor the wrapper allocates, the second h @ W2. h makes a round
// trip through device memory: 42 MB written and read at ViT-H, ~25 us at
// 3.35 TB/s if none of it stayed in the 50 MB L2, against the products'
// 109 us floor. Keeping h on chip would need each output column group to
// recompute its hidden tiles (N / BN times the first product) or a cluster
// sharing them through distributed shared memory; neither was tried. The
// result is the same function with the same roundings; only the float32
// sum order differs. float32 takes a CUDA-core path in one launch: 16 rows
// per block, hidden sub-tiles of whole W2 pack blocks (at most 128) in
// shared memory, the (16, 1280) accumulator in registers (5 columns of 16
// rows per thread).
#include "qmm_tc.cuh"

namespace samq_quant {

constexpr int HT = 512;       // H is a multiple of this (fused_mlp_supported)
constexpr int CW = 128;       // N is a multiple of this
constexpr int MAX_GW = 1280;  // output columns per float32 block; wider N takes more groups

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

  // Hidden sub-tiles are whole pack blocks of W2 (fht rows of it); K tiles
  // whole pack blocks of W1.
  const int kt1 = tile_rows(pb1), fht = tile_rows(pb2);
  for (int h0 = 0; h0 < H; h0 += fht) {
    // Phase 1: thread (r0, c) computes a[r0 + r, c] for 8 rows (c < fht used).
    float a[FBM / 2];
#pragma unroll
    for (int r = 0; r < FBM / 2; ++r) a[r] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kt1) {
      __syncthreads();  // the previous tiles are consumed
      fill_x_tile<float, FBM, KT, THREADS>(xs, FXLD, x, m0, M, k0, K, kt1, vec);
      fill_weight_tile<float, BITS, FHT, THREADS>(wbuf, FHT, qw1, nullptr, s1, z1, k0, K, h0, H,
                                                  pb1, g1, kt1);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kt1; ++kk) {
        const float w = wbuf[kk * FHT + c];
#pragma unroll
        for (int r = 0; r < FBM / 2; ++r) a[r] = fmaf(xs[(r0 + r) * FXLD + kk], w, a[r]);
      }
    }
    const float bias = h0 + c < H ? __ldg(b1 + h0 + c) : 0.f;
#pragma unroll
    for (int r = 0; r < FBM / 2; ++r) hs[(r0 + r) * FHT + c] = gelu_tanh(__fadd_rn(a[r], bias));

    // Phase 2: acc[r][j] += h[r, :] @ W2[h0:h0+fht, c0 + tid + 256 j].
#pragma unroll
    for (int j = 0; j < FNJ; ++j) {
      if (j * THREADS >= gw) break;
      __syncthreads();  // h is complete; the previous W2 tile is consumed
      fill_weight_tile<float, BITS, THREADS, THREADS>(wbuf, THREADS, qw2, nullptr, s2, z2, h0, H,
                                                      c0 + j * THREADS, N, pb2, g2, fht);
      __syncthreads();
#pragma unroll 4
      for (int hh = 0; hh < fht; ++hh) {
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
               void* hidden, int M, int K, int H, int N, int g1, int pb1, int g2, int pb2,
               cudaStream_t st) {
  if (dtype == 1) {
    if (hidden == nullptr) return (int)cudaErrorInvalidValue;
    __nv_bfloat16* h = static_cast<__nv_bfloat16*>(hidden);
    const int err = tc::run<BITS, tc::BIAS_GELU>(static_cast<const __nv_bfloat16*>(x), w1,
                                                 nullptr, s1, z1, b1, h, M, K, H, pb1, g1, st);
    if (err) return err;
    return tc::run<BITS, tc::PLAIN>(h, w2, nullptr, s2, z2, nullptr,
                                    static_cast<__nv_bfloat16*>(out), M, H, N, pb2, g2, st);
  }
  return launch(fused_mlp_f32_kernel<BITS>, dim3((M + FBM - 1) / FBM, (N + MAX_GW - 1) / MAX_GW),
                THREADS, F32_SMEM, st, static_cast<const float*>(x), w1, s1, z1, b1, w2, s2, z2,
                static_cast<float*>(out), M, K, H, N, g1, pb1, g2, pb2,
                vec_ok(x, K, tile_rows(pb1), 4));
}

}  // namespace samq_quant

// dtype: 0 float32, 1 bfloat16. Both weights have `bits` in (2, 4, 8); H a
// multiple of 512 and N of 128 (fused_mlp_supported); b1 is float32 (H,)
// (zeros for no bias). hidden: bf16 (M, H) scratch for h (bfloat16 only;
// unread for float32, may be null). Returns the CUDA error of the launches
// (0 on success).
extern "C" int samq_fused_mlp(int dtype, int bits, const void* x, const void* qw1,
                              const void* s1, const void* z1, const void* b1, const void* qw2,
                              const void* s2, const void* z2, void* out, void* hidden, int M,
                              int K, int H, int N, int g1, int pb1, int g2, int pb2,
                              void* stream) {
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
  run<B>(dtype, x, w1, fs1, fz1, fb1, w2, fs2, fz2, out, hidden, M, K, H, N, g1, pb1, g2, pb2, st)
  switch (bits) {
    case 2: return SAMQ_RUN(2);
    case 4: return SAMQ_RUN(4);
    default: return SAMQ_RUN(8);
  }
#undef SAMQ_RUN
}
