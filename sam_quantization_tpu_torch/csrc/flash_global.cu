// Global attention with decomposed rel-pos bias.
//
// Replaces: sam_quantization_tpu/ops/flash_attention.py::_attn_kernel_rowblock_bias3d
// (:552-628, launched by _fused_attention_bias3d :637-677 from the dispatch
// in flash_attention_relpos :826-873). It computes the same function: a plain
// hd-wide q.k product plus rel_h[m, n // kw] + rel_w[m, n % kw], the clamped
// static-shift exp2 softmax with deferred normalisation, and the optional
// int8 epilogue, on q, k, v of shape (B*nh, L, hd).
//
// What bounds it on an H100: at ViT-H (BH 16, L 4096, hd 80) one block is
// 85.9 GFLOP of products (87 us at 989 TFLOP/s bf16) against ~59 MB of
// traffic (18 us at 3.35 TB/s), so it is bound by operations; its 268 M
// exponentials (about 69 us at the SFU rate) come close to that bound too.
//
// Design: the TPU kernel held all of K and V in VMEM (640 KB each at this
// shape); a Hopper block has at most 227 KB of shared memory, so each block
// streams K, V in 64-key tiles instead. The softmax shift is static, so the
// stream needs no running max and no rescale: sum p.v and sum p accumulate
// in float32 and divide once at the end. Unlike the TPU dispatch it needs
// neither kw | 128 nor L > 512: every global block takes it.
// - bfloat16 (flash_tc.cuh): two warpgroups of 64 query rows a block, both
//   products on wgmma (q.k m64n64k16 from shared memory, p.v m64n16k16 with
//   p in registers), K/V by cp.async into a two-stage ring. With the
//   products on the tensor cores, the per-logit work on the CUDA cores
//   (bias, clamp, exp2, row sums, bf16 packing: about 16 instructions for
//   each of the 268 M logits) and the wait on each product bound it, not
//   the tensor cores; the 64 x 64 rel grid reads rel_w by column pairs and
//   rel_h once per tile, with no index table (with the table alone it took
//   1.9x as long).
// - float32 (flash_f32.cuh, the body of every float32 attention build):
//   one block per 64 query rows, both products on the CUDA cores in FFMA,
//   bound by operations at 67 TFLOP/s (1.28 ms at ViT-H). Where kw divides
//   64 (ViT-H: 64) each thread holds its rel_w' in registers and a tile's
//   rel_h' slice rides in the K/V ring (BIAS_REGS: 107,520 bytes at hd 80,
//   two stages and two blocks an SM); any other kw (128 on a 2048 px image),
//   and the head tiles where those registers spill (flash_f32.cuh's
//   register policy), keep the block's rel rows in shared memory
//   (BIAS_ROWS). The wrapper pads hd to a multiple of 4 and aligns the
//   operands (16-byte copies); other operands take 4-byte copies.
#include "flash_f32.cuh"
#include "flash_tc.cuh"

namespace samq {

template <typename T>
__device__ __forceinline__ Problem<T> global_problem(const T* q, const T* k, const T* v,
                                                     const T* rel_h, const T* rel_w, int L,
                                                     int hd, int kh, int kw, float q_scale) {
  const long bh = blockIdx.y;
  const long off = bh * L * hd;
  Problem<T> P;
  P.q = q + off;
  P.k = k + off;
  P.v = v + off;
  P.q_stride = P.kv_stride = hd;
  P.rel_h = rel_h + bh * L * kh;
  P.rel_w = rel_w + bh * L * kw;
  P.rel_h_stride = kh;
  P.rel_w_stride = kw;
  P.L = L;
  P.hd = hd;
  P.kh = kh;
  P.kw = kw;
  P.q_scale = q_scale;
  return P;
}

// float32: the register-tiled CUDA-core body.
template <int HDP, int BIAS, typename OutT>
__global__ void __launch_bounds__(f32t::THREADS, f32t::global_blocks(HDP))
    flash_global_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ rel_h,
                            const float* __restrict__ rel_w, OutT* __restrict__ out, int L,
                            int hd, int kh, int kw, float q_scale, float ois, bool vec,
                            int stages) {
  const Problem<float> P = global_problem(q, k, v, rel_h, rel_w, L, hd, kh, kw, q_scale);
  f32t::attend<HDP, BIAS, OutT, f32t::qk_unroll(false, HDP)>(
      P, blockIdx.x * f32t::BQ, out + (long)blockIdx.y * L * hd, hd, ois, stages, vec);
}

// bfloat16: the tensor-core body, hd padded to HDP in shared memory only.
template <int HDP, typename OutT>
__global__ void __launch_bounds__(tc::NTHREADS, tc::min_blocks<HDP>())
    flash_global_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ rel_h,
                           const __nv_bfloat16* __restrict__ rel_w, OutT* __restrict__ out,
                           int L, int hd, int kh, int kw, float q_scale, float ois, bool vec) {
  const Problem<__nv_bfloat16> P = global_problem(q, k, v, rel_h, rel_w, L, hd, kh, kw, q_scale);
  tc::attend_rows_tc<HDP, false, OutT>(P, blockIdx.x * tc::BQ, out + (long)blockIdx.y * L * hd,
                                       hd, ois, vec);
}

template <typename OutT>
static int run_f32(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                   void* out, int BH, int L, int hd, int kh, int kw, float q_scale, float ois,
                   cudaStream_t stream) {
  const bool vec = f32t::vec_ok(hd, {q, k, v});
  return tc::dispatch_hdp(hd, [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    const dim3 grid((L + f32t::BQ - 1) / f32t::BQ, BH);
    const auto with_bias = [&](auto bias) {
      constexpr int BIAS = decltype(bias)::value;
      return f32t::launch<HDP, BIAS, f32t::global_blocks(HDP)>(
          flash_global_f32_kernel<HDP, BIAS, OutT>, grid, kh, kw, stream,
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(rh),
          static_cast<const float*>(rw), static_cast<OutT*>(out), L, hd, kh, kw, q_scale, ois,
          vec);
    };
    if constexpr (f32t::regs_bias_fits(HDP)) {
      if (f32t::bias_for(HDP, kw) == f32t::BIAS_REGS)
        return with_bias(std::integral_constant<int, f32t::BIAS_REGS>{});
    }
    return with_bias(std::integral_constant<int, f32t::BIAS_ROWS>{});
  });
}

template <typename OutT>
static int run_tc(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                  void* out, int BH, int L, int hd, int kh, int kw, float q_scale, float ois,
                  cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bool vec = hd % 8 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  return tc::dispatch_hdp(hd, [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    const dim3 grid((L + tc::BQ - 1) / tc::BQ, BH);
    return launch(flash_global_tc_kernel<HDP, OutT>, grid, tc::NTHREADS,
                  tc::smem_bytes(HDP, kh, kw), stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const bf16*>(rh), static_cast<const bf16*>(rw),
                  static_cast<OutT*>(out), L, hd, kh, kw, q_scale, ois, vec);
  });
}

}  // namespace samq

// dtype: 0 float32, 1 bfloat16. out_int8: write int8 with out_inv_scale.
// Returns the CUDA error of the launch (0 on success).
extern "C" int samq_flash_global(int dtype, int out_int8, const void* q, const void* k,
                                 const void* v, const void* rel_h, const void* rel_w, void* out,
                                 int BH, int L, int hd, int kh, int kw, float q_scale, float ois,
                                 void* stream) {
  using namespace samq;
  if (hd < 1 || hd > MAX_HD || kh * kw != L || BH < 1 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return out_int8
               ? run_f32<int8_t>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw, q_scale, ois, s)
               : run_f32<float>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw, q_scale, ois, s);
  if (dtype == 1)
    return out_int8
               ? run_tc<int8_t>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw, q_scale, ois, s)
               : run_tc<__nv_bfloat16>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw, q_scale,
                                       ois, s);
  return (int)cudaErrorInvalidValue;
}
