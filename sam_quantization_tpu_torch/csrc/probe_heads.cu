// Attention ablation kernels on pre-split heads: the measurement builds of
// the TPU stage probes, P2-P5 of the kernel table (PERF.md).
//
// Replaces (tools/packed_probe.py, tools/global_stage_probe.py):
//   _kernel_dots_floor (packed_probe.py:97)  MODE NONE:   o = round(q.k) . v
//   _kernel_presplit   (packed_probe.py:111) MODE ROWMAX: p = exp2(s - max s)
//                                             (exp with exp2 0)
//   _k_pair            (global_stage_probe.py:183) ROWMAX, or CLAMP:
//                                             p = exp2(min(s, 40) - 40)
//   _k_pair_bias       (global_stage_probe.py:316) the same with BIAS:
//                                             s += rw[n % kw] + rh[n // kw]
// On q, k, v of shape (BH, L, D) in bfloat16 (the probes pad heads to
// D = 128 with zeros, and padded keys take part), s = q.k in float32 with no
// scale (the callers prescale q where they want one), the bias in float32
// from the raw bf16 tiles rh (BH, L, kh) and rw (BH, L, kw), and
//   NONE:         out = round(sum_n round(s) v[n])
//   ROWMAX/CLAMP: out = round((sum_n round(p) v[n]) * (1 / sum_n p))
// with round = to bfloat16, nearest even; no other rounding.
//
// What bounds it on an H100: at the shapes the probes run, (25 x 16, 256,
// 128) for P2/P3 and (16, 4096, 128) for P4/P5, the two products are 13.4
// and 137 GFLOP against 105 and 67 MB of bf16 traffic: P2/P3 are bound by
// bytes (31 us at 3.35 TB/s), P4/P5 by the bf16 tensor cores (139 us).
//
// Two bodies:
// - The row-max and clamp-40 softmax, with and without a bias (P3, P4, P5),
//   run probe_tc.cuh: both products on wgmma, the row max exact by a first
//   q.k pass, IEEE gradual underflow in p as the plain version has it.
// - The dot-only mode (P2) runs dots_floor_kernel below: 64 query rows of
//   one problem a block, keys streamed through shared memory in 64-row
//   tiles, both products on the CUDA cores in float32.
#include <math.h>

#include "probe_tc.cuh"

namespace samq {

inline size_t dots_smem_bytes(int D) {
  const int ld = D + 1;
  return 4 * ((size_t)BQ * ld + (size_t)BK * ld + (size_t)BK * D + (size_t)BQ * (BK + 1));
}

// out = round(sum_n round(q.k[n]) v[n]) for 64 query rows a block.
__global__ void __launch_bounds__(NTHREADS)
    dots_floor_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int L,
                      int D) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ld = D + 1, m0 = blockIdx.x * BQ;
  const long off = (long)blockIdx.y * L * D;
  q += off;
  k += off;
  v += off;
  out += off;
  float* Qs = smem;                // BQ x ld
  float* Ks = Qs + BQ * ld;        // BK x ld
  float* Vs = Ks + BK * ld;        // BK x D
  float* Ps = Vs + BK * D;         // BQ x (BK + 1), round(s)

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i - r * D, m = m0 + r;
    Qs[r * ld + c] = m < L ? __bfloat162float(q[(long)m * D + c]) : 0.f;
  }
  float acc[4][MAX_HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_HD / 16; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < L; n0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i - r * D, n = n0 + r;
      Ks[r * ld + c] = n < L ? __bfloat162float(k[(long)n * D + c]) : 0.f;
      Vs[r * D + c] = n < L ? __bfloat162float(v[(long)n * D + c]) : 0.f;
    }
    __syncthreads();
    // s[i][j] = q[row ty + 16 i] . k[key tx + 16 j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ld + d];
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
        if (c < D) {
          const float vv = Vs[n * D + c];
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
      if (c < D) out[(long)m * D + c] = __float2bfloat16(acc[i][j]);
    }
  }
}

}  // namespace samq

// mode: 0 dots only (P2), 1 row-max softmax (P3, P4, P5), 2 clamp-40 softmax
// (P4, P5). exp2: 0 takes exp instead (row-max without bias only). has_bias:
// add rw[n % kw] + rh[n // kw] (kh * kw == L). Operands bfloat16,
// contiguous; the softmax modes take them as probe_tc.cuh's run does (D a
// multiple of 8, q, k, v 16-byte aligned). Mode 0 runs the CUDA-core body,
// the others the tensor-core one. Returns the CUDA error of the launch (0
// on success).
extern "C" int samq_probe_heads(int mode, int exp2, int has_bias, const void* q, const void* k,
                                const void* v, const void* rh, const void* rw, void* out, int BH,
                                int L, int D, int kh, int kw, void* stream) {
  using namespace samq;
  if (D < 1 || D > MAX_HD || L < 1 || BH < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  if (has_bias && (kh < 1 || kw < 1 || kh * kw != L)) return (int)cudaErrorInvalidValue;
  if (!has_bias) kh = kw = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using T = __nv_bfloat16;
  if (mode == PROBE_NONE && !has_bias)
    return launch(dots_floor_kernel, dim3((L + BQ - 1) / BQ, BH), dots_smem_bytes(D), s,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(out), L, D);
  if (mode == PROBE_ROWMAX && !has_bias)
    return exp2 ? ptc::run<PROBE_ROWMAX, true, false>(q, k, v, nullptr, nullptr, out, BH, L, D,
                                                      0, 0, 1.f, s)
                : ptc::run<PROBE_ROWMAX, false, false>(q, k, v, nullptr, nullptr, out, BH, L, D,
                                                       0, 0, 1.f, s);
  if (mode == PROBE_CLAMP && !has_bias)
    return ptc::run<PROBE_CLAMP, true, false>(q, k, v, nullptr, nullptr, out, BH, L, D, 0, 0,
                                              1.f, s);
  if (mode == PROBE_ROWMAX && exp2)
    return ptc::run<PROBE_ROWMAX, true, true>(q, k, v, rh, rw, out, BH, L, D, kh, kw, 1.f, s);
  if (mode == PROBE_CLAMP)
    return ptc::run<PROBE_CLAMP, true, true>(q, k, v, rh, rw, out, BH, L, D, kh, kw, 1.f, s);
  return (int)cudaErrorInvalidValue;
}
