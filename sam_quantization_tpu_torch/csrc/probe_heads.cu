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
// - The row-max and clamp-40 softmax without a bias (P3, P4) run
//   probe_tc.cuh: both products on wgmma, the row max exact by a first q.k
//   pass, IEEE gradual underflow in p as the plain version has it.
// - The dot-only mode (P2) and the biased modes (P5) run probe_heads_kernel
//   below: the body of flash_common.cuh's attend_rows (64 query rows of one
//   problem a block, keys streamed through shared memory in 64-row tiles,
//   both products on the CUDA cores in float32), with the softmax as a
//   template parameter. Its row max is exact the same way (a first pass of
//   q.k over the key tiles, 1.5x the work of a clamped pass); the clamped
//   and dot-only modes take one pass. P5's step toward the bound is
//   probe_tc.cuh plus the bias.
#include <math.h>

#include "probe_tc.cuh"

namespace samq {

inline size_t heads_smem_bytes(int D, int kh, int kw) {
  const int ld = D + 1;
  return 4 * ((size_t)BQ * ld + (size_t)BK * ld + (size_t)BK * D + (size_t)BQ * (BK + 1) +
              (size_t)BQ * (kh + kw) + 2 * BK);
}

// s[i][j] = q[row ty + 16 i] . k[key tx + 16 j] (+ bias) for the tile in Ks.
template <bool BIAS>
__device__ __forceinline__ void tile_logits(const float* Qs, const float* Ks, const float* Rh,
                                            const float* Rw, const int* colh, const int* colw,
                                            int ld, int D, int kh, int kw, int tx, int ty,
                                            float (&s)[4][4]) {
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
  if constexpr (BIAS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] += Rw[r * kw + colw[c]] + Rh[r * kh + colh[c]];
      }
    }
  }
}

template <int MODE, bool BIAS>
__global__ void __launch_bounds__(NTHREADS)
    probe_heads_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rh,
                       const __nv_bfloat16* __restrict__ rw, __nv_bfloat16* __restrict__ out,
                       int L, int D, int kh, int kw) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ld = D + 1, m0 = blockIdx.x * BQ;
  const long bh = blockIdx.y, off = bh * L * D;
  q += off;
  k += off;
  v += off;
  out += off;
  float* Qs = smem;                // BQ x ld
  float* Ks = Qs + BQ * ld;        // BK x ld
  float* Vs = Ks + BK * ld;        // BK x D
  float* Ps = Vs + BK * D;         // BQ x (BK + 1), round(p)
  float* Rh = Ps + BQ * (BK + 1);  // BQ x kh, raw rh
  float* Rw = Rh + BQ * kh;        // BQ x kw
  int* colh = reinterpret_cast<int*>(Rw + BQ * kw);  // n // kw for the tile
  int* colw = colh + BK;                             // n % kw

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i - r * D, m = m0 + r;
    Qs[r * ld + c] = m < L ? __bfloat162float(q[(long)m * D + c]) : 0.f;
  }
  if constexpr (BIAS) {
    for (int i = tid; i < BQ * kh; i += NTHREADS) {
      const int r = i / kh, c = i - r * kh, m = m0 + r;
      Rh[i] = m < L ? __bfloat162float(rh[(bh * L + m) * kh + c]) : 0.f;
    }
    for (int i = tid; i < BQ * kw; i += NTHREADS) {
      const int r = i / kw, c = i - r * kw, m = m0 + r;
      Rw[i] = m < L ? __bfloat162float(rw[(bh * L + m) * kw + c]) : 0.f;
    }
  }

  // Load the key tile at n0 (and its values, and the bias index rows).
  auto load_tile = [&](int n0, bool values) {
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i - r * D, n = n0 + r;
      Ks[r * ld + c] = n < L ? __bfloat162float(k[(long)n * D + c]) : 0.f;
      if (values) Vs[r * D + c] = n < L ? __bfloat162float(v[(long)n * D + c]) : 0.f;
    }
    if (BIAS && tid < BK) {
      const int n = n0 + tid, hq = n / kw;
      colh[tid] = hq;
      colw[tid] = n - hq * kw;
    }
  };

  float mrow[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if constexpr (MODE == PROBE_ROWMAX) {
    for (int n0 = 0; n0 < L; n0 += BK) {
      __syncthreads();  // the previous tile is consumed
      load_tile(n0, false);
      __syncthreads();
      float s[4][4];
      tile_logits<BIAS>(Qs, Ks, Rh, Rw, colh, colw, ld, D, kh, kw, tx, ty, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + tx + 16 * j < L) mrow[i] = fmaxf(mrow[i], s[i][j]);
    }
    // The 16 threads of a row group are lanes tx = 0..15 of a half warp.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) mrow[i] = fmaxf(mrow[i], __shfl_xor_sync(0xffffffffu, mrow[i], o));
  }

  float acc[4][MAX_HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_HD / 16; ++j) acc[i][j] = 0.f;
  float lsum[4] = {0.f, 0.f, 0.f, 0.f};

  for (int n0 = 0; n0 < L; n0 += BK) {
    __syncthreads();
    load_tile(n0, true);
    __syncthreads();
    float s[4][4];
    tile_logits<BIAS>(Qs, Ks, Rh, Rw, colh, colw, ld, D, kh, kw, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = 0.f;
        if (n0 + c < L) {
          if constexpr (MODE == PROBE_NONE) {
            p = round_to<__nv_bfloat16>(s[i][j]);
          } else {
            float e;
            if constexpr (MODE == PROBE_CLAMP)
              e = exp2f(fminf(s[i][j], PAIR_CAP) - PAIR_CAP);
            else
              e = exp2f(s[i][j] - mrow[i]);
            lsum[i] += e;
            p = round_to<__nv_bfloat16>(e);
          }
        }
        Ps[r * (BK + 1) + c] = p;
      }
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

  if constexpr (MODE != PROBE_NONE) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], o);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= L) continue;
    const float r = MODE == PROBE_NONE ? 1.f : 1.f / lsum[i];
#pragma unroll
    for (int j = 0; j < MAX_HD / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        const float o = acc[i][j];
        out[(long)m * D + c] = __float2bfloat16(MODE == PROBE_NONE ? o : o * r);
      }
    }
  }
}

template <int MODE, bool BIAS>
static int run(const void* q, const void* k, const void* v, const void* rh, const void* rw,
               void* out, int BH, int L, int D, int kh, int kw, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const dim3 grid((L + BQ - 1) / BQ, BH);
  return launch(probe_heads_kernel<MODE, BIAS>, grid, heads_smem_bytes(D, kh, kw), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(rh), static_cast<const T*>(rw), static_cast<T*>(out), L, D,
                kh, kw);
}

}  // namespace samq

// mode: 0 dots only (P2), 1 row-max softmax (P3, P4, P5), 2 clamp-40 softmax
// (P4, P5). exp2: 0 takes exp instead (row-max without bias only). has_bias:
// add rw[n % kw] + rh[n // kw] (kh * kw == L). Operands bfloat16,
// contiguous. Modes 1 and 2 without a bias run the tensor-core body
// (probe_tc.cuh), the others the CUDA-core one. Returns the CUDA error of
// the launch (0 on success).
extern "C" int samq_probe_heads(int mode, int exp2, int has_bias, const void* q, const void* k,
                                const void* v, const void* rh, const void* rw, void* out, int BH,
                                int L, int D, int kh, int kw, void* stream) {
  using namespace samq;
  if (D < 1 || D > MAX_HD || L < 1 || BH < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  if (has_bias && (kh < 1 || kw < 1 || kh * kw != L)) return (int)cudaErrorInvalidValue;
  if (!has_bias) kh = kw = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == PROBE_NONE && !has_bias)
    return run<PROBE_NONE, false>(q, k, v, rh, rw, out, BH, L, D, kh, kw, s);
  if (mode == PROBE_ROWMAX && !has_bias)
    return exp2 ? ptc::run<PROBE_ROWMAX, true>(q, k, v, out, BH, L, D, s)
                : ptc::run<PROBE_ROWMAX, false>(q, k, v, out, BH, L, D, s);
  if (mode == PROBE_CLAMP && !has_bias)
    return ptc::run<PROBE_CLAMP, true>(q, k, v, out, BH, L, D, s);
  if (mode == PROBE_ROWMAX && exp2)
    return run<PROBE_ROWMAX, true>(q, k, v, rh, rw, out, BH, L, D, kh, kw, s);
  if (mode == PROBE_CLAMP)
    return run<PROBE_CLAMP, true>(q, k, v, rh, rw, out, BH, L, D, kh, kw, s);
  return (int)cudaErrorInvalidValue;
}
