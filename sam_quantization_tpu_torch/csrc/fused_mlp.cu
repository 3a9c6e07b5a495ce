// Fused quantized MLP: out (M, N) = round(gelu_tanh(x @ W1 + b1)) @ W2, both
// weights block-planar packed with the same bit width (2, 4 or 8), float32
// accumulation, output in x's type. b2 is added outside the kernel.
//
// Replaces: sam_quantization_tpu/ops/fused_mlp.py::_fused_mlp_kernel (:28-49),
// launched by _fused_mlp_call (:56-91) through fused_mlp (:129-176). Same
// function, same order: a = x @ dequant(W1) + b1 in float32, h =
// gelu_tanh(a) in float32 rounded to x's type, out = h @ dequant(W2) summed
// in float32 and rounded to x's type. The TPU kernel keeps h in VMEM, one
// hidden tile of 512 at a time; here it passes through device memory
// between two launches (below).
//
// What bounds it on an H100: at ViT-H (M 4096, K = N 1280, H 5120, 4-bit)
// the two products are 107.4 GFLOP against ~22 MB moved in bf16 (~43 MB in
// float32): 109 us of bf16 tensor-core time, or 1.60 ms at the 67 TFLOP/s
// float32 FFMA peak, against 7 (13) us of memory, so it is bound by
// operations in both types.
//
// The trap: the TPU kernel keeps a (256, N) float32 accumulator in VMEM
// (1.3 MB at N 1280); a Hopper SM has 227 KB of shared memory and 256 KB of
// registers, and a (64, 1280) float32 sum alone is 320 KB. Design: two
// launches of one body, the first x @ W1 with the +b1 -> gelu_tanh epilogue
// into h (M, H) in x's type, a scratch tensor the wrapper allocates, the
// second h @ W2. bfloat16 runs the tensor-core body of qmm_tc.cuh, float32
// the register-tiled FFMA body of qmm_f32.cuh. h makes a round trip through
// device memory: 42 MB (bf16) or 84 MB (f32) written and read at ViT-H,
// ~25 or ~50 us at 3.35 TB/s if none of it stayed in the 50 MB L2, against
// the products' 109 us (bf16 tensor cores) or 1.60 ms (f32 FFMA) floor.
// Keeping h on chip would need each output column tile to recompute its
// hidden tiles (N / BN times the first product) or a cluster sharing them
// through distributed shared memory; neither was tried. The result is the
// same function with the same roundings; only the float32 sum order
// differs.
#include "qmm_f32.cuh"
#include "qmm_tc.cuh"

namespace samq_quant {

constexpr int HT = 512;  // H is a multiple of this (fused_mlp_supported)
constexpr int CW = 128;  // N is a multiple of this

// x @ W1 -> +b1 -> gelu_tanh into h, then h @ W2 into out, by one body's
// two epilogues (first, second).
template <typename T, typename First, typename Second>
static int two_launches(First first, Second second, const T* x, const int32_t* w1,
                        const float* s1, const float* z1, const float* b1, const int32_t* w2,
                        const float* s2, const float* z2, T* h, T* out, int M, int K, int H,
                        int N, int g1, int pb1, int g2, int pb2, cudaStream_t st) {
  const int err = first(x, w1, nullptr, s1, z1, b1, h, M, K, H, pb1, g1, st);
  return err ? err : second(h, w2, nullptr, s2, z2, nullptr, out, M, H, N, pb2, g2, st);
}

template <int BITS>
static int run(int dtype, const void* x, const int32_t* w1, const float* s1, const float* z1,
               const float* b1, const int32_t* w2, const float* s2, const float* z2, void* out,
               void* hidden, int M, int K, int H, int N, int g1, int pb1, int g2, int pb2,
               cudaStream_t st) {
  if (hidden == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return two_launches(tc::run<BITS, tc::BIAS_GELU>, tc::run<BITS, tc::PLAIN>,
                        static_cast<const T*>(x), w1, s1, z1, b1, w2, s2, z2,
                        static_cast<T*>(hidden), static_cast<T*>(out), M, K, H, N, g1, pb1, g2,
                        pb2, st);
  }
  return two_launches(f32::run<BITS, f32::BIAS_GELU>, f32::run<BITS, f32::PLAIN>,
                      static_cast<const float*>(x), w1, s1, z1, b1, w2, s2, z2,
                      static_cast<float*>(hidden), static_cast<float*>(out), M, K, H, N, g1,
                      pb1, g2, pb2, st);
}

}  // namespace samq_quant

// dtype: 0 float32, 1 bfloat16. Both weights have `bits` in (2, 4, 8); H a
// multiple of 512 and N of 128 (fused_mlp_supported); b1 is float32 (H,)
// (zeros for no bias). hidden: (M, H) scratch for h in x's type, required
// for both types. Returns the CUDA error of the launches (0 on success).
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
