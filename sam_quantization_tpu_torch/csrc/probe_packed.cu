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
// Design: flash_windowed's (flash_common.cuh): one block per (64 query rows,
// head, window) reads its q rows once and streams the head's k, v and rel
// rows in 64-key tiles through shared memory, where the augmented rows are
// assembled; both products run on the CUDA cores in float32. Output is at
// head columns, as the TPU kernel writes it.
#include "flash_common.cuh"

namespace samq {

constexpr int PROBE_MAX_R = 128;  // rel columns (kh + kw) the tiles take

inline size_t packed_smem_bytes(int hd, int R) {
  const int ld = hd + R + 1;
  return 4 * ((size_t)BQ * ld + (size_t)BK * ld + (size_t)BK * hd + (size_t)BQ * (BK + 1));
}

__global__ void __launch_bounds__(NTHREADS)
    probe_no_softmax_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ rel, __nv_bfloat16* __restrict__ out,
                            int L, int nh, int hd, int R, long long row_stride,
                            long long win_stride, float scale) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, m0 = blockIdx.x * BQ, Da = hd + R, ld = Da + 1;
  const long long w = blockIdx.z, C = (long long)nh * hd;
  const long long base = w * win_stride + (long long)h * hd;
  const __nv_bfloat16* rel_w = rel + (w * nh + h) * L * R;
  float* Qa = smem;             // BQ x ld: round(q * scale) | rel
  float* Ka = Qa + BQ * ld;     // BK x ld: k | rel
  float* Vs = Ka + BK * ld;     // BK x hd
  float* Ps = Vs + BK * hd;     // BQ x (BK + 1), round(s)

  for (int i = tid; i < BQ * Da; i += NTHREADS) {
    const int r = i / Da, c = i - r * Da, m = m0 + r;
    float x = 0.f;
    if (m < L)
      x = c < hd ? round_to<__nv_bfloat16>(__bfloat162float(q[base + m * row_stride + c]) * scale)
                 : __bfloat162float(rel_w[(long long)m * R + c - hd]);
    Qa[r * ld + c] = x;
  }

  float acc[4][MAX_HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_HD / 16; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < L; n0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * Da; i += NTHREADS) {
      const int r = i / Da, c = i - r * Da, n = n0 + r;
      float x = 0.f;
      if (n < L)
        x = c < hd ? __bfloat162float(k[base + n * row_stride + c])
                   : __bfloat162float(rel_w[(long long)n * R + c - hd]);
      Ka[r * ld + c] = x;
    }
    for (int i = tid; i < BK * hd; i += NTHREADS) {
      const int r = i / hd, c = i - r * hd, n = n0 + r;
      Vs[i] = n < L ? __bfloat162float(v[base + n * row_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Da; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qa[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ka[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ps[(ty + 16 * i) * (BK + 1) + c] = n0 + c < L ? round_to<__nv_bfloat16>(s[i][j]) : 0.f;
      }
    __syncthreads();

    const int nk = min(BK, L - n0);
    for (int n = 0; n < nk; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + n];
#pragma unroll
      for (int j = 0; j < MAX_HD / 16; ++j) {
        const int c = tx + 16 * j;
        if (c < hd) {
          const float vv = Vs[n * hd + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= L) continue;
#pragma unroll
    for (int j = 0; j < MAX_HD / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < hd) out[(w * L + m) * C + (long long)h * hd + c] = __float2bfloat16(acc[i][j]);
    }
  }
}

}  // namespace samq

// q, k, v: bfloat16 (NW, L, nh*hd) with rows row_stride and windows
// win_stride elements apart (the same for all three), last dim contiguous;
// rel: bfloat16 (NW, nh, L, R), contiguous; out: bfloat16 (NW, L, nh*hd),
// contiguous. Returns the CUDA error of the launch (0 on success).
extern "C" int samq_probe_no_softmax(const void* q, const void* k, const void* v, const void* rel,
                                     void* out, int NW, int L, int nh, int hd, int R,
                                     long long row_stride, long long win_stride, float scale,
                                     void* stream) {
  using namespace samq;
  if (hd < 1 || hd > MAX_HD || R < 0 || R > PROBE_MAX_R || L < 1 || NW < 1 || NW > 65535 ||
      nh < 1 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const dim3 grid((L + BQ - 1) / BQ, nh, NW);
  return launch(probe_no_softmax_kernel, grid, packed_smem_bytes(hd, R),
                static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(rel),
                static_cast<T*>(out), L, nh, hd, R, row_stride, win_stride, scale);
}
