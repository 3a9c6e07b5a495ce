// The windowed attention kernel's dots without its softmax: the measurement
// build of the TPU packed-kernel probe, P1 of the kernel table (PERF.md).
//
// Replaces: tools/packed_probe.py::_kernel_no_softmax (:71, called at :222).
// On q, k, v of shape (NW, L, nh*hd) with head h at columns h*hd (rows may
// be strided, so slices of the packed qkv projection output are read in
// place, as flash_windowed reads them) and rel (NW, nh, L, R), per window
// and head, in bfloat16:
//   qa[m] = [round(q[m] * scale) | rel[m]],   ka[n] = [k[n] | rel[n]]
//   s[m, n] = qa[m] . ka[n]  (float32, over hd + R)
//   out[m] = round(sum_n round(s[m, n]) v[n])
// with round = to bfloat16, nearest even: the same rel rows on both sides,
// no softmax and no normalisation. The TPU kernel reads Lp-row blocks past
// the L rows it is given (its driver notes that those rows are garbage);
// this function is defined on the L real rows, which equals the TPU
// kernel's answer on inputs zero-padded to Lp rows.
//
// What bounds it on an H100: at ViT-H (NW 25, nh 16, L 196, hd 80, R 28)
// it moves 54.6 MB of bf16 (q, k, v 37.6, rel 4.4, out 12.5) for 5.8 GFLOP:
// 16 us of memory at 3.35 TB/s against 6 us of bf16 tensor-core time, so it
// is bound by bytes.
//
// Design: probe_tc.cuh's AUG policy, the dot-only pass of P2 (round(s)
// packed straight into p.v's register operand, no carry, no row sum) with
// FLASH's in-place q scale (q_scale = scale, no log2 e) and two changes:
// - Heads in place: TMA reads zeros only past a tensor's own edge, and
//   column h*hd + hd is the next head's first column. So q, k and v are 4D
//   tensor maps (hd, nh, L, NW) with element strides 1 and hd, then the row
//   and the window stride; a box of 64 columns of one head ends at hd. The
//   wrapper copies q, k and v (hd padded to a multiple of 8) where hd or a
//   stride is not a multiple of 8 elements or a start not of 16 bytes.
// - The rel columns are extra depth of q.k: a rel tile of the block's 128
//   rows comes with q and one of the step's 64 keys with each K tile (3D
//   maps of boxes of 64 rows), and R' / 16 more k16 steps of wgmma join the
//   hd steps' accumulator chain. rel rows of R = 28 are 56 bytes, which TMA
//   cannot stride, so the wrapper pads R to R' = round_up(R, 8) with zeros,
//   which add nothing to s. The padding (and any copy) is part of the call.
// Output is at head columns (row stride nh*hd), stored a pair of columns at
// a time from the accumulators; rows m >= L are not stored, keys n >= L
// give round(s) = 0.
#include "probe_tc.cuh"

namespace samq {
namespace ptc {

// The heads of a (NW, L, nh * D) operand read in place (rows row_stride and
// windows win_stride elements apart) as a 4D tensor map (D, nh, L, NW) of
// boxes of 64 columns by `rows` rows of one head: past D (the next head's
// columns) and past L the box reads zeros.
inline bool encode_heads(CUtensorMap* map, const void* x, int NW, int L, int nh, int D,
                         long long row_stride, long long win_stride, int rows) {
  const auto fn = samq_tma::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)nh, (cuuint64_t)L, (cuuint64_t)NW};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)row_stride * 2,
                                 (cuuint64_t)win_stride * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1}, estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch AUG (P1) on q, k, v of shape (NW, L, nh * D) read in place (rows
// row_stride and windows win_stride elements apart, the same for all three;
// D <= MAX_HD, both strides and D multiples of 8, q, k and v 16-byte
// aligned) with rel (NW, nh, L, R) contiguous, R <= PROBE_MAX_R a multiple
// of 8 (zero columns add nothing), 16-byte aligned; out (NW, L, nh * D)
// contiguous. Anything else is refused.
inline int run_aug(const void* q, const void* k, const void* v, const void* rel, void* out,
                   int NW, int L, int nh, int D, int R, long long row_stride,
                   long long win_stride, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (D % 8 != 0 || R < 0 || R % 8 != 0 || R > PROBE_MAX_R || row_stride % 8 != 0 ||
      win_stride % 8 != 0 || (long)NW * nh > 65535 || !aligned(q, 16) || !aligned(k, 16) ||
      !aligned(v, 16) || !aligned(rel, 16) || !aligned(out, 4))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!(encode_heads(&maps.q, q, NW, L, nh, D, row_stride, win_stride, BQ) &&
        encode_heads(&maps.k, k, NW, L, nh, D, row_stride, win_stride, BK) &&
        encode_heads(&maps.v, v, NW, L, nh, D, row_stride, win_stride, BK) &&
        (R == 0 || encode(&maps.r, rel, NW * nh, L, R, BK))))
    return (int)cudaErrorNotSupported;
  const Args a{static_cast<bf16*>(out), nullptr, nullptr, L, D, 0, 0, 0, scale, nh,
               atoms(R), (R + 15) / 16};
  return launch_body<PROBE_AUG, true, false>(maps, a, NW * nh, stream);
}

}  // namespace ptc
}  // namespace samq

// q, k, v: bfloat16 (NW, L, nh*hd) with rows row_stride and windows
// win_stride elements apart (the same for all three), last dim contiguous;
// rel: bfloat16 (NW, nh, L, R), contiguous; out: bfloat16 (NW, L, nh*hd),
// contiguous. hd, R and both strides multiples of 8, q, k, v and rel
// 16-byte aligned (ptc::run_aug). Returns the CUDA error of the launch (0 on
// success).
extern "C" int samq_probe_no_softmax(const void* q, const void* k, const void* v, const void* rel,
                                     void* out, int NW, int L, int nh, int hd, int R,
                                     long long row_stride, long long win_stride, float scale,
                                     void* stream) {
  using namespace samq;
  if (hd < 1 || hd > MAX_HD || L < 1 || NW < 1 || nh < 1) return (int)cudaErrorInvalidValue;
  return ptc::run_aug(q, k, v, rel, out, NW, L, nh, hd, R, row_stride, win_stride, scale,
                      static_cast<cudaStream_t>(stream));
}
