// Head-split attention, with or without a decomposed rel-pos bias.
//
// Replaces: sam_quantization_tpu/ops/flash_attention.py::_attn_kernel
// (:213-239, whole problems, launched by _fused_attention's bw > 1 branch
// :711-733) and ::_attn_kernel_rowblock (:680-699, one row block per
// program, the bw == 1 branch :734-754), both reached from the generic
// dispatch of flash_attention_relpos (:875-913). Those two differ only in
// their TPU tiling; they compute one function, and this file computes it,
// launched behind two counters (flash_whole for L <= 512, the
// windowed training forward; flash_rowblock for longer L, the rel-less global
// blocks). On q, k, v of shape (BH, L, hd) and, with REL, rel_h (BH, L, kh)
// and rel_w (BH, L, kw):
//   s = q.k * scale (+ rel_h[m, n // kw] + rel_w[m, n % kw]),
// the clamped static-shift exp2 softmax, p rounded to T before p.v, float32
// sums, normalisation after p.v, output in T (JAX's routes 8 and 9 ignore
// out_inv_scale, so there is no int8 epilogue here). In float32, step for
// step those of flash_common.cuh:10-21 with T = float:
//   qs = q * (scale * log2 e),  rel' = rel * log2 e
//   s  = qs.k + (rel_w'[m, n % kw] + rel_h'[m, n // kw])
//   p  = exp2(clip(s, -60, 64) - 64);  out = (sum_n p v) * (1 / sum_n p)
//
// The JAX kernels fold the bias into the contraction (q augmented with
// rel_h | rel_w, k with one-hot selectors, padded to Da = round_up(hd + kh +
// kw, 128)) to put it on the MXU, and pad L to Lp = round_up(L, 128) with a
// -1e30 column mask. Neither is needed here: the bias is added per element
// from shared-memory rows, and keys n >= L do not exist.
//
// What bounds it on an H100: at the ViT-H training shape (BH 400, L 196,
// hd 80, rel 14 + 14) the products are 4.9 GFLOP against about 54 MB of bf16
// traffic, so bf16 is bound by bytes (16 us at 3.35 TB/s) and float32, whose
// products run on the CUDA cores, by operations (73 us at 67 TFLOP/s). The
// rel-less ViT-H global shape (BH 16, L 4096, hd 80) is 85.9 GFLOP, bound
// by operations (87 us in bf16, 1.28 ms in float32).
//
// Two bodies, one for each dtype (ops/flash_attention.py's body() names them):
// - bfloat16, both counters (flash_whole: the rel-less encode's windowed
//   blocks and any short problem; flash_rowblock: the long-L rows, rel-less
//   at ViT-H's global blocks, or with a rel grid the bias3d kernel does not
//   take), runs probe_tc.cuh's FLASH mode: q, K and V by TMA from a
//   producer warp into a ring of 128-byte-swizzled tiles, q.k and p.v on
//   wgmma, qs and rel' formed in shared memory as above, p carried times
//   2^64. hd stays unpadded in device memory (TMA reads zeros past hd: hd
//   80 is five k16 steps of q.k and one m64n64k16 plus one m64n16k16 of
//   p.v); the wrapper pads hd to a multiple of 8 and copies unaligned
//   operands for TMA. The ptxas pitfalls it avoids are in probe_tc.cuh's
//   header; FLASH met no new diagnostic. At flash_whole's L 196 a block
//   computes 128 rows against four key tiles, the last holding 4 real keys,
//   one block an SM; flash_tc.cuh's body (flash_windowed's: a cp.async ring
//   and a block barrier a tile, the last 4 keys as a 16-key tile, two blocks
//   an SM) took as long with 14 + 14 rel tiles and 1.2x as long rel-less
//   (PERF.md), so the TMA body serves both counters.
// - float32 (flash_whole, the windowed training forward, and
//   flash_rowblock) runs flash_f32.cuh's register-tiled body, both products
//   on the CUDA cores in float32 (tensor cores would mean TF32, which the
//   trainer's gradient check does not take): 4 x 4 logits a thread, K and V
//   by cp.async into a two-stage ring, the rel rows in shared memory
//   (BIAS_ROWS; at hd 80 with 14 + 14 rel columns a block needs 110 KB, two
//   blocks an SM). The wrapper pads hd to a multiple of 4 and aligns the
//   operands, so every copy moves 16 bytes. The rel-less path is a
//   compile-time branch. flash_windowed and flash_global run the same body.
// The TPU's whole-problem batching (bw problems per program, all of K and
// V in VMEM) buys nothing here, since a problem's K and V come from L2 for
// each of its row blocks.
#include "flash_f32.cuh"
#include "probe_tc.cuh"

namespace samq {

// float32: one (batch, head) a blockIdx.y, rows blockIdx.x * 64 ..; hd a
// multiple of 4, q, k, v 16-byte aligned (the 16-byte copies).
template <int HDP, bool REL>
__global__ void __launch_bounds__(f32t::THREADS, 2)
    flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ rel_h,
                          const float* __restrict__ rel_w, float* __restrict__ out, int L, int hd,
                          int kh, int kw, float q_scale, int stages) {
  const long bh = blockIdx.y, off = bh * L * hd;
  Problem<float> P;
  P.q = q + off;
  P.k = k + off;
  P.v = v + off;
  P.rel_h = rel_h + bh * L * kh;
  P.rel_w = rel_w + bh * L * kw;
  P.q_stride = P.kv_stride = hd;
  P.rel_h_stride = kh;
  P.rel_w_stride = kw;
  P.L = L;
  P.hd = hd;
  P.kh = kh;
  P.kw = kw;
  P.q_scale = q_scale;
  constexpr int BIAS = REL ? f32t::BIAS_ROWS : f32t::BIAS_NONE;
  f32t::attend<HDP, BIAS, float, f32t::qk_unroll(true, HDP)>(P, blockIdx.x * f32t::BQ, out + off,
                                                            hd, 0.f, stages, true);
}

// Launch on (BH, L, hd) float32 operands, hd a multiple of 4 and q, k, v
// 16-byte aligned (what the wrapper's tma_operands gives); a shape that
// leaves no room for one stage is refused.
template <bool REL>
inline int run_f32(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                   void* out, int BH, int L, int hd, int kh, int kw, float q_scale,
                   cudaStream_t stream) {
  if (!f32t::vec_ok(hd, {q, k, v})) return (int)cudaErrorInvalidValue;
  return tc::dispatch_hdp(hd, [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    return f32t::launch<HDP, REL ? f32t::BIAS_ROWS : f32t::BIAS_NONE>(
        flash_attn_f32_kernel<HDP, REL>, dim3((L + f32t::BQ - 1) / f32t::BQ, BH), kh, kw, stream,
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(rh), static_cast<const float*>(rw), static_cast<float*>(out), L,
        hd, kh, kw, q_scale);
  });
}

}  // namespace samq

// dtype: 0 float32, 1 bfloat16. has_rel: 0 for no bias (kh, kw ignored).
// body: 1 the TMA tensor-core body (bfloat16), 3 the register-tiled
// CUDA-core body (float32); ops/flash_attention.py's body() numbers them.
// hd a multiple of 8 (bfloat16) or 4 (float32), q, k, v 16-byte aligned.
// Returns the CUDA error of the launch (0 on success).
extern "C" int samq_flash_attn(int dtype, int has_rel, int body, const void* q, const void* k,
                               const void* v, const void* rel_h, const void* rel_w, void* out,
                               int BH, int L, int hd, int kh, int kw, float q_scale,
                               void* stream) {
  using namespace samq;
  if (hd < 1 || hd > MAX_HD || L < 1 || BH < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  if (has_rel && (kh < 1 || kw < 1 || kh * kw != L)) return (int)cudaErrorInvalidValue;
  if (!has_rel) kh = kw = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1 && dtype == 1)
    return has_rel ? ptc::run<FLASH_CLIP, true, true>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh,
                                                      kw, q_scale, s)
                   : ptc::run<FLASH_CLIP, true, false>(q, k, v, nullptr, nullptr, out, BH, L, hd,
                                                       0, 0, q_scale, s);
  if (body == 3 && dtype == 0)
    return has_rel ? run_f32<true>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw, q_scale, s)
                   : run_f32<false>(q, k, v, nullptr, nullptr, out, BH, L, hd, 0, 0, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
