// Windowed multi-head attention with decomposed rel-pos bias, read straight
// from the qkv projection output.
//
// Replaces: sam_quantization_tpu/ops/flash_attention.py::_attn_kernel_qkv_packed
// (:242-379, launched by _fused_attention_qkv_packed :389-438). It computes
// the same function: q/k/v of head h are the column slices h*hd, C + h*hd and
// 2C + h*hd of the (NW, L, 3C) qkv tensor; the bias is
// rel[nw, h, m, n // kw] + rel[nw, h, m, kh + n % kw]; the softmax is the
// clamped static-shift exp2 form with deferred normalisation, and an optional
// int8 epilogue quantises for an int8 consumer. Output is (NW, L, C) at head
// columns, ready for the proj linear.
//
// What bounds it on an H100: at ViT-H (NW 25, nh 16, L 196, hd 80) the block
// moves ~55 MB (qkv 37.6 + rel 4.4 + out 12.5, bf16) for 4.9 GFLOP: 16 us of
// memory at 3.35 TB/s against 5 us of bf16 tensor-core time, so it is bound
// by bytes. The TPU kernel folded the bias into an augmented contraction
// because its matrix unit pads hd to 128 lanes anyway; here the bias is added
// directly from shared memory, and the TPU's padding of L to Lp does not
// exist (keys n >= L are skipped).
//
// Design: each block reads its q rows once and the head's k/v once (the
// window's row blocks share them through L2), writes each output once, and
// streams k/v through shared memory in 64-key tiles.
// - bfloat16 (flash_tc.cuh): one block per (128 query rows, head, window),
//   two warpgroups of 64 rows, both products on wgmma, K/V by cp.async into
//   a two-stage ring straight from the (NW, L, 3C) rows (16-byte head
//   slices). L 196 is 3 * 64 + 4: the last tile runs a 16-key body, and the
//   second block's second warpgroup holds 4 real rows, so about a quarter
//   of the product work is padding. At ViT-H 800 blocks run two to an SM
//   (three rounds on 132 SMs and a short fourth); the per-block set-up and
//   the wait on each product, not the bytes, bound it.
// - float32 (flash_f32.cuh, the body of every float32 attention build):
//   one block per (64 query rows, head, window), grid (4, 16, 25) at
//   ViT-H, both products on the CUDA cores in FFMA, K and V by cp.async into
//   a two-stage ring straight from the qkv rows at row stride 3C (16-byte
//   copies where hd % 4 == 0 and qkv is 16-byte aligned, else 4-byte ones),
//   the 14 + 14 rel rows in shared memory (BIAS_ROWS: 112,640 bytes at hd
//   80, two blocks an SM). The block of the last 4 rows and the tile of the
//   last 4 keys skip their empty row and key groups.
#include "flash_f32.cuh"
#include "flash_tc.cuh"

namespace samq {

template <typename T>
__device__ __forceinline__ Problem<T> windowed_problem(const T* qkv, const T* rel, int L, int nh,
                                                       int hd, int kh, int kw, float q_scale) {
  const int h = blockIdx.y;
  const long w = blockIdx.z;
  const long C = (long)nh * hd;
  const T* base = qkv + w * L * 3 * C + (long)h * hd;
  const T* rel_base = rel + (w * nh + h) * L * (kh + kw);
  Problem<T> P;
  P.q = base;
  P.k = base + C;
  P.v = base + 2 * C;
  P.q_stride = P.kv_stride = 3 * C;
  P.rel_h = rel_base;
  P.rel_w = rel_base + kh;
  P.rel_h_stride = P.rel_w_stride = kh + kw;
  P.L = L;
  P.hd = hd;
  P.kh = kh;
  P.kw = kw;
  P.q_scale = q_scale;
  return P;
}

// float32: the register-tiled CUDA-core body.
template <int HDP, typename OutT>
__global__ void __launch_bounds__(f32t::THREADS, 2)
    flash_windowed_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ rel,
                              OutT* __restrict__ out, int L, int nh, int hd, int kh, int kw,
                              float q_scale, float ois, bool vec, int stages) {
  const Problem<float> P = windowed_problem(qkv, rel, L, nh, hd, kh, kw, q_scale);
  const long C = (long)nh * hd;
  OutT* o = out + (long)blockIdx.z * L * C + (long)blockIdx.y * hd;
  f32t::attend<HDP, f32t::BIAS_ROWS, OutT, f32t::qk_unroll(false, HDP)>(
      P, blockIdx.x * f32t::BQ, o, C, ois, stages, vec);
}

// bfloat16: the tensor-core body, hd padded to HDP in shared memory only.
template <int HDP, typename OutT>
__global__ void __launch_bounds__(tc::NTHREADS, tc::min_blocks<HDP>())
    flash_windowed_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ rel, OutT* __restrict__ out,
                             int L, int nh, int hd, int kh, int kw, float q_scale, float ois,
                             bool vec) {
  const Problem<__nv_bfloat16> P = windowed_problem(qkv, rel, L, nh, hd, kh, kw, q_scale);
  const long C = (long)nh * hd;
  OutT* o = out + (long)blockIdx.z * L * C + (long)blockIdx.y * hd;
  tc::attend_rows_tc<HDP, true, OutT>(P, blockIdx.x * tc::BQ, o, C, ois, vec);
}

template <typename OutT>
static int run_f32(const void* qkv, const void* rel, void* out, int NW, int L, int nh, int hd,
                   int kh, int kw, float q_scale, float ois, cudaStream_t stream) {
  // Rows of 3 nh hd values, head slices at hd: all 16-byte aligned iff hd % 4 == 0.
  const bool vec = f32t::vec_ok(hd, {qkv});
  return tc::dispatch_hdp(hd, [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    const dim3 grid((L + f32t::BQ - 1) / f32t::BQ, nh, NW);
    return f32t::launch<HDP, f32t::BIAS_ROWS>(
        flash_windowed_f32_kernel<HDP, OutT>, grid, kh, kw, stream,
        static_cast<const float*>(qkv), static_cast<const float*>(rel), static_cast<OutT*>(out),
        L, nh, hd, kh, kw, q_scale, ois, vec);
  });
}

template <typename OutT>
static int run_tc(const void* qkv, const void* rel, void* out, int NW, int L, int nh, int hd,
                  int kh, int kw, float q_scale, float ois, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  // Rows of 3 nh hd values, head slices at hd: all 16-byte aligned iff hd % 8 == 0.
  const bool vec = hd % 8 == 0 && (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;
  return tc::dispatch_hdp(hd, [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    const dim3 grid((L + tc::BQ - 1) / tc::BQ, nh, NW);
    return launch(flash_windowed_tc_kernel<HDP, OutT>, grid, tc::NTHREADS,
                  tc::smem_bytes(HDP, kh, kw), stream, static_cast<const bf16*>(qkv),
                  static_cast<const bf16*>(rel), static_cast<OutT*>(out), L, nh, hd, kh, kw,
                  q_scale, ois, vec);
  });
}

}  // namespace samq

// dtype: 0 float32, 1 bfloat16. out_int8: write int8 with out_inv_scale.
// Returns the CUDA error of the launch (0 on success).
extern "C" int samq_flash_windowed(int dtype, int out_int8, const void* qkv, const void* rel,
                                   void* out, int NW, int L, int nh, int hd, int kh, int kw,
                                   float q_scale, float ois, void* stream) {
  using namespace samq;
  if (hd < 1 || hd > MAX_HD || kh * kw != L || NW < 1 || NW > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return out_int8 ? run_f32<int8_t>(qkv, rel, out, NW, L, nh, hd, kh, kw, q_scale, ois, s)
                    : run_f32<float>(qkv, rel, out, NW, L, nh, hd, kh, kw, q_scale, ois, s);
  if (dtype == 1)
    return out_int8
               ? run_tc<int8_t>(qkv, rel, out, NW, L, nh, hd, kh, kw, q_scale, ois, s)
               : run_tc<__nv_bfloat16>(qkv, rel, out, NW, L, nh, hd, kh, kw, q_scale, ois, s);
  return (int)cudaErrorInvalidValue;
}
