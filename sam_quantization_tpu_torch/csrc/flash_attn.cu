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
// out_inv_scale, so there is no int8 epilogue here).
//
// The JAX kernels fold the bias into the contraction (q augmented with
// rel_h | rel_w, k with one-hot selectors, padded to Da = round_up(hd + kh +
// kw, 128)) to put it on the MXU, and pad L to Lp = round_up(L, 128) with a
// -1e30 column mask. Neither is needed here: the bias is added per element
// from shared-memory tiles (flash_common.cuh), and keys n >= L do not exist.
//
// What bounds it on an H100: at the ViT-H training shape (BH 400, L 196,
// hd 80, rel 14 + 14) the products are 4.9 GFLOP against about 54 MB of bf16
// traffic, so bf16 is bound by bytes (16 us at 3.35 TB/s) and float32, whose
// products run on the CUDA cores, by operations (73 us at 67 TFLOP/s). The
// rel-less ViT-H global shape (BH 16, L 4096, hd 80) is 85.9 GFLOP, bound
// by operations (87 us in bf16).
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
//   flash_rowblock) runs flash_common.cuh's attend_rows: 64 query rows of
//   one problem a block, K and V streamed in 64-key tiles, both products on
//   the CUDA cores in float32 (tensor cores would mean TF32). The rel-less
//   path is a compile-time branch that touches no bias tile.
// The TPU's whole-problem batching (bw problems per program, all of K and
// V in VMEM) buys nothing here, since a problem's K and V come from L2 for
// each of its row blocks.
#include "probe_tc.cuh"

namespace samq {

template <typename T, bool REL>
__global__ void __launch_bounds__(NTHREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ rel_h,
                      const T* __restrict__ rel_w, T* __restrict__ out, int L, int hd, int kh,
                      int kw, float q_scale) {
  const long bh = blockIdx.y;
  const long off = bh * L * hd;
  Problem<T> P;
  P.q = q + off;
  P.k = k + off;
  P.v = v + off;
  P.q_stride = P.kv_stride = hd;
  P.rel_h = REL ? rel_h + bh * L * kh : nullptr;
  P.rel_w = REL ? rel_w + bh * L * kw : nullptr;
  P.rel_h_stride = kh;
  P.rel_w_stride = kw;
  P.L = L;
  P.hd = hd;
  P.kh = kh;
  P.kw = kw;
  P.q_scale = q_scale;
  attend_rows<T, T, REL>(P, blockIdx.x * BQ, out + off, hd, 0.f);
}

template <bool REL>
static int run(const void* q, const void* k, const void* v, const void* rh, const void* rw,
               void* out, int BH, int L, int hd, int kh, int kw, float q_scale,
               cudaStream_t stream) {
  const dim3 grid((L + BQ - 1) / BQ, BH);
  return launch(flash_attn_kernel<float, REL>, grid, smem_bytes(hd, kh, kw), stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(rh),
                static_cast<const float*>(rw), static_cast<float*>(out), L, hd, kh, kw, q_scale);
}

}  // namespace samq

// dtype: 0 float32, 1 bfloat16. has_rel: 0 for no bias (kh, kw ignored).
// body: 0 attend_rows on the CUDA cores (float32), 1 the TMA tensor-core
// body (bfloat16; hd a multiple of 8, q, k, v 16-byte aligned). Returns the
// CUDA error of the launch (0 on success).
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
  if (body == 0 && dtype == 0)
    return has_rel ? run<true>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw, q_scale, s)
                   : run<false>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
