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
// g 128) the product is 48.2 GFLOP against ~53 MB moved in bf16 (x 12.5 MB,
// out 37.6 MB, packed weights with scales and zeros 2.8 MB; ~103 MB in
// float32): 49 us of bf16 tensor-core time, or 0.72 ms at the 67 TFLOP/s
// float32 FFMA peak, against 16 (31) us of memory, so it is bound by
// operations in both types.
//
// Design: bfloat16 runs the tensor-core body of qmm_tc.cuh (wgmma products,
// the weight decode overlapped with them), float32 the register-tiled FFMA
// body of qmm_f32.cuh (8 x 8 accumulators a thread, 4 FMAs per shared word,
// x by cp.async into a second stage while the FMAs run, the next weight
// tile's words loaded into registers ahead of its decode); their notes have
// the layouts and the arithmetic. The weights are decoded M / bm times in all.
//
// Tiles: the caller names the output tile, bm x bn outputs a block
// (ops/quant_matmul.py's pick_blocks: a tuned table's entry, else the
// default; ops/autotune.py's TILES lists the same tiles):
//   bfloat16 256 x 128 (the default), 256 x 64;
//   float32  128 x 128 (the default).
// The bodies are templates on the tile and take more (qmm_tc.cuh and
// qmm_f32.cuh's Tile); only tiles that were fastest at a measured layer
// shape are instantiated. A tile changes only which block computes an
// output: every tile walks K in the same tiles of tile_rows(pack_block)
// rows, so each output's sum runs in the same order and the bfloat16 tiles
// give the same bits.
#include "qmm_f32.cuh"
#include "qmm_tc.cuh"

namespace samq_quant {

template <int BITS>
static int run(int dtype, int bm, int bn, const void* x, const int32_t* qw, const int32_t* qh,
               const float* s, const float* z, void* out, int M, int K, int N, int pb, int g,
               cudaStream_t st) {
  using BF = __nv_bfloat16;
#define SAMQ_TC(TBM, TBN)                                                              \
  if (bm == TBM && bn == TBN)                                                          \
    return tc::run<BITS, tc::PLAIN, TBM, TBN>(static_cast<const BF*>(x), qw, qh, s, z, \
                                             nullptr, static_cast<BF*>(out), M, K, N, \
                                             pb, g, st);
#define SAMQ_F32(TBM, TBN)                                                                \
  if (bm == TBM && bn == TBN)                                                             \
    return f32::run<BITS, f32::PLAIN, TBM, TBN>(static_cast<const float*>(x), qw, qh, s, z, \
                                               nullptr, static_cast<float*>(out), M, K, N, \
                                               pb, g, st);
  if (dtype == 1) {
    SAMQ_TC(256, 128)
    SAMQ_TC(256, 64)
  } else {
    SAMQ_F32(128, 128)
  }
#undef SAMQ_TC
#undef SAMQ_F32
  return (int)cudaErrorInvalidValue;  // not an instantiated tile
}

}  // namespace samq_quant

// dtype: 0 float32, 1 bfloat16. bits 2, 4, 8, or 3 with qweight_hi. The
// tile: bm x bn outputs a block, bk K rows a tile, which must be
// tile_rows(pack_block). A tile that is not instantiated returns
// cudaErrorInvalidValue; it is not rounded to another.
// Returns the CUDA error of the launch (0 on success).
extern "C" int samq_quant_matmul(int dtype, int bits, const void* x, const void* qweight,
                                 const void* qweight_hi, const void* scales, const void* zeros,
                                 void* out, int M, int K, int N, int groupsize, int pack_block,
                                 int bm, int bn, int bk, void* stream) {
  using namespace samq_quant;
  if ((dtype != 0 && dtype != 1) || M < 1 || bn < 1 || (N + bn - 1) / bn > 65535 ||
      !packing_ok(bits, K, N, pack_block, groupsize) || (bits == 3 && qweight_hi == nullptr) ||
      bk != tile_rows(pack_block))
    return (int)cudaErrorInvalidValue;
  const int32_t* qw = static_cast<const int32_t*>(qweight);
  const int32_t* qh = static_cast<const int32_t*>(qweight_hi);
  const float* s = static_cast<const float*>(scales);
  const float* z = static_cast<const float*>(zeros);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SAMQ_RUN(B) run<B>(dtype, bm, bn, x, qw, qh, s, z, out, M, K, N, pack_block, groupsize, st)
  switch (bits) {
    case 2: return SAMQ_RUN(2);
    case 3: return SAMQ_RUN(3);
    case 4: return SAMQ_RUN(4);
    default: return SAMQ_RUN(8);
  }
#undef SAMQ_RUN
}
