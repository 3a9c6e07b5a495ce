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
// One body, probe_tc.cuh, for every mode: both products on wgmma, K and V
// by TMA from a producer warp. The dot-only mode (P2) makes one pass and
// packs round(s) straight into p.v's register operand; the softmax modes
// (P3, P4, P5) take the row max exact by a first q.k pass and keep IEEE
// gradual underflow in p as the plain version has it.
#include "probe_tc.cuh"

// mode: 0 dots only (P2, no bias), 1 row-max softmax (P3, P4, P5), 2
// clamp-40 softmax (P4, P5). exp2: 0 takes exp instead (row-max without bias
// only; the dot-only mode ignores it). has_bias: add rw[n % kw] + rh[n // kw]
// (kh * kw == L). Operands bfloat16, contiguous, as probe_tc.cuh's run takes
// them (D a multiple of 8, q, k, v 16-byte aligned). Returns the CUDA error
// of the launch (0 on success).
extern "C" int samq_probe_heads(int mode, int exp2, int has_bias, const void* q, const void* k,
                                const void* v, const void* rh, const void* rw, void* out, int BH,
                                int L, int D, int kh, int kw, void* stream) {
  using namespace samq;
  if (D < 1 || D > MAX_HD || L < 1 || BH < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  if (has_bias && (kh < 1 || kw < 1 || kh * kw != L)) return (int)cudaErrorInvalidValue;
  if (!has_bias) kh = kw = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == PROBE_NONE && !has_bias)
    return ptc::run<PROBE_NONE, true, false>(q, k, v, nullptr, nullptr, out, BH, L, D, 0, 0,
                                             1.f, s);
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
