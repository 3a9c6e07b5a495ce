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
// step those of flash_common.cuh:6-17 with T = float:
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
//   flash_rowblock) runs the register-tiled body below, both products on the
//   CUDA cores in float32 (tensor cores would mean TF32, which the trainer's
//   gradient check does not take). What held attend_rows back, and what this
//   body does instead:
//   - Shared-memory loads bounded its products: a scalar load for every two
//     FMAs from rows of odd pitch. Here a block of 256 threads holds 64
//     query rows against 64-key tiles; a thread keeps 4 rows x 4 keys of s
//     and 4 rows x HDP / 16 columns of the output in registers. q and K rows
//     sit at a pitch of HDP + 4 floats, so one 128-bit load along d serves
//     four depth steps of a row or a key, and the 8 keys a quarter warp
//     reads hit 8 distinct bank groups (8 loads for 64 FMAs). p.v reads p
//     four keys a load and each V row 128 bits a thread (4 columns of each
//     64, then HDP % 64 / 16 more).
//   - Warps an SM matter more than the tile: 8 x 8 logits a thread at 128
//     threads a block (four warps an SM) ran no faster than 4 x 4 at 256
//     (PERF.md). So a block is held to 128 registers a thread and
//     to half the SM's shared memory, two blocks an SM: p takes the K region
//     of its tile's stage once q.k has read it (a third barrier a tile), and
//     at hd 80 with 14 + 14 rel columns a block needs 110 KB.
//   - K and V went through registers with an integer division a value and
//     three block barriers a tile. Here they come by cp.async, 16 bytes a
//     copy, zero-filled past L and past hd, into a two-stage ring: tile t +
//     1 lands while tile t is multiplied. A shape whose rel rows or HDP leave
//     no room for two stages at two blocks an SM takes one stage, or one
//     block an SM.
//   - At L 196 the 64 x 64 tiles computed 256 x 256 logits for 196 x 196.
//     Here the row and key groups of 16 that hold no real row or key are
//     skipped in q.k, and p.v stops at the last real key (rounded up to 4),
//     so a block of the last 4 rows or a tile of the last 4 keys costs about
//     a quarter of a whole one. The variants are compile-time (IN, JN).
//   - The block's rel_h' and rel_w' rows sit in shared memory; a thread
//     forms n // kw and n % kw of a key once a tile, with no table.
//   p goes through shared memory (each thread's p.v needs every key of its
//   rows). The rel-less path is a compile-time branch.
// The TPU's whole-problem batching (bw problems per program, all of K and
// V in VMEM) buys nothing here, since a problem's K and V come from L2 for
// each of its row blocks.
#include "probe_tc.cuh"

namespace samq {
namespace f32t {

constexpr int BQ = 64;         // query rows a block
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;   // 16 x 16: ty the row group, tx the key (and column) group
constexpr int PP = BK + 16;    // p's row pitch (floats): the two row groups of a warp apart
constexpr size_t SM_SMEM = 233472;  // shared memory of an sm_90 SM, 1 KB of it a block's own

__host__ __device__ constexpr int qpitch(int hdp) { return hdp + 4; }
// Floats of a stage's K region, which holds the K tile and then the tile's p.
__host__ __device__ constexpr int kregion(int hdp) {
  return BK * qpitch(hdp) > BQ * PP ? BK * qpitch(hdp) : BQ * PP;
}

// Dynamic shared memory: q, `stages` K regions and V tiles, and the rel rows.
inline size_t smem_bytes(int hdp, int kh, int kw, int stages) {
  return 4 * ((size_t)BQ * qpitch(hdp) + stages * ((size_t)kregion(hdp) + (size_t)BK * hdp) +
              (size_t)BQ * (kh + kw));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// s[i][j] = q row (ty + 16 i) . K row (tx + 16 j) over HDP, for the IN row
// groups and JN key groups in use; d in steps of four, one 128-bit load of
// each operand a step.
template <int HDP, int IN, int JN>
__device__ __forceinline__ void qk(float (&s)[4][4], const float* Qs, const float* Kd, int ty,
                                   int tx) {
  constexpr int QP = qpitch(HDP);
#pragma unroll
  for (int i = 0; i < IN; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HDP; d += 4) {
    float4 a[IN], b[JN];
#pragma unroll
    for (int i = 0; i < IN; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QP + d);
#pragma unroll
    for (int j = 0; j < JN; ++j) b[j] = *reinterpret_cast<const float4*>(Kd + (tx + 16 * j) * QP + d);
#pragma unroll
    for (int i = 0; i < IN; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        float x = fmaf(a[i].x, b[j].x, s[i][j]);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        s[i][j] = fmaf(a[i].w, b[j].w, x);
      }
  }
}

// o[i][c] += sum over keys 0 .. nk4 - 1 of p[row][n] V[n][col c], rows ty +
// 16 i for the IN row groups in use; column c of a thread is 64 (c / 4) + 4 tx
// + c % 4 in the 64-column chunks, then 64 N64 + RW tx + (c - 4 N64).
template <int HDP, int IN>
__device__ __forceinline__ void pv(float (&o)[4][4 * (HDP / 64) + HDP % 64 / 16], const float* Ps,
                                   const float* Vd, int nk4, int ty, int tx) {
  constexpr int N64 = HDP / 64, RW = HDP % 64 / 16, TD = 4 * N64 + RW;
  for (int n = 0; n < nk4; n += 4) {
    float4 pr[IN];
#pragma unroll
    for (int i = 0; i < IN; ++i) pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PP + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* vr = Vd + (n + e) * HDP;
      float vv[TD];
#pragma unroll
      for (int c = 0; c < N64; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(vr + 64 * c + 4 * tx);
        vv[4 * c] = x.x;
        vv[4 * c + 1] = x.y;
        vv[4 * c + 2] = x.z;
        vv[4 * c + 3] = x.w;
      }
      if constexpr (RW == 2) {
        const float2 x = *reinterpret_cast<const float2*>(vr + 64 * N64 + 2 * tx);
        vv[4 * N64] = x.x;
        vv[4 * N64 + 1] = x.y;
      } else {
#pragma unroll
        for (int c = 0; c < RW; ++c) vv[4 * N64 + c] = vr[64 * N64 + RW * tx + c];
      }
#pragma unroll
      for (int i = 0; i < IN; ++i) {
        const float p = e == 0 ? pr[i].x : e == 1 ? pr[i].y : e == 2 ? pr[i].z : pr[i].w;
#pragma unroll
        for (int c = 0; c < TD; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
  }
}

// f(std::integral_constant<int, n>) for n in 1..4.
template <typename F>
__device__ __forceinline__ void with_groups(int n, F&& f) {
  switch (n) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    default: f(std::integral_constant<int, 4>{}); break;
  }
}

// One (batch, head) a blockIdx.y, rows blockIdx.x * BQ ..; hd a multiple of 4
// up to HDP, q, k, v 16-byte aligned; `stages` 1 or 2.
template <int HDP, bool REL>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ rel_h,
                          const float* __restrict__ rel_w, float* __restrict__ out, int L, int hd,
                          int kh, int kw, float q_scale, int stages) {
  constexpr int QP = qpitch(HDP), C4 = HDP / 4, N64 = HDP / 64, RW = HDP % 64 / 16;
  constexpr int TD = 4 * N64 + RW, KR = kregion(HDP);
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                    // BQ x QP: q * q_scale, zeros past L and hd
  float* Ks = Qs + BQ * QP;           // [stage] KR: BK x QP of K, then BQ x PP of p
  float* Vs = Ks + stages * KR;       // [stage] BK x HDP
  float* Rh = Vs + stages * BK * HDP; // BQ x kh: rel_h * log2 e
  float* Rw = Rh + BQ * kh;           // BQ x kw: rel_w * log2 e
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, m0 = blockIdx.x * BQ;
  const long off = (long)blockIdx.y * L * hd;
  q += off;
  k += off;
  v += off;
  out += off;
  const int hd4 = hd / 4;  // 16-byte chunks of a device-memory row

  for (int i = tid; i < BQ * C4; i += THREADS) {
    const int r = i / C4, c = i - r * C4, m = m0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < L && c < hd4) {
      x = *reinterpret_cast<const float4*>(q + (long)m * hd + 4 * c);
      x.x *= q_scale;
      x.y *= q_scale;
      x.z *= q_scale;
      x.w *= q_scale;
    }
    *reinterpret_cast<float4*>(Qs + r * QP + 4 * c) = x;
  }
  if constexpr (REL) {
    const long ro = (long)blockIdx.y * L;
    for (int i = tid; i < BQ * kh; i += THREADS) {
      const int r = i / kh, m = m0 + r;
      Rh[i] = m < L ? rel_h[(ro + m) * kh + i - r * kh] * LOG2E_F : 0.f;
    }
    for (int i = tid; i < BQ * kw; i += THREADS) {
      const int r = i / kw, m = m0 + r;
      Rw[i] = m < L ? rel_w[(ro + m) * kw + i - r * kw] * LOG2E_F : 0.f;
    }
  }

  // K and V of tile t into stage st, committed as one group.
  auto load_tile = [&](int t, int st) {
    float* Kd = Ks + st * KR;
    float* Vd = Vs + st * BK * HDP;
    for (int i = tid; i < BK * C4; i += THREADS) {
      const int r = i / C4, c = i - r * C4, n = t * BK + r;
      const bool ok = n < L && c < hd4;
      const long src = ok ? (long)n * hd + 4 * c : 0;
      cp16(Kd + r * QP + 4 * c, k + src, ok);
      cp16(Vd + r * HDP + 4 * c, v + src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int tiles = (L + BK - 1) / BK;
  const int in = (min(BQ, L - m0) + 15) / 16;  // row groups holding real rows
  float o[4][TD], lsum[4] = {0.f, 0.f, 0.f, 0.f}, s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TD; ++c) o[i][c] = 0.f;

  if (stages == 2) load_tile(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int st = stages == 2 ? t & 1 : 0;
    if (stages == 1) {
      if (t > 0) __syncthreads();  // the previous tile's p.v is done
      load_tile(t, 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // tile t landed for all; stage (t + 1) & 1 is free
    if (stages == 2 && t + 1 < tiles) load_tile(t + 1, (t + 1) & 1);
    float* Kd = Ks + st * KR;
    const int n0 = t * BK, nk = min(BK, L - n0), jn = (nk + 15) / 16;
    with_groups(in, [&](auto I) {
      with_groups(jn, [&](auto J) { qk<HDP, decltype(I)::value, decltype(J)::value>(s, Qs, Kd, ty, tx); });
    });
    __syncthreads();  // the K tile is read: its region takes p
    float* Ps = Kd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= jn) break;
      const int c = tx + 16 * j, n = n0 + c;
      const int hq = REL ? n / kw : 0, wq = n - hq * kw;  // key n's rel columns
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= in) break;
        const int r = ty + 16 * i;
        float p = 0.f;
        if (n < L) {
          float x = s[i][j];
          if constexpr (REL) x += Rw[r * kw + wq] + Rh[r * kh + hq];
          x = fminf(fmaxf(x, CLAMP_FLOOR), CLAMP_CAP);
          p = exp2f(x - CLAMP_CAP);
          lsum[i] += p;
        }
        Ps[r * PP + c] = p;
      }
    }
    __syncthreads();  // p of the tile is whole
    with_groups(in, [&](auto I) {
      pv<HDP, decltype(I)::value>(o, Ps, Vs + st * BK * HDP, (nk + 3) & ~3, ty, tx);
    });
  }

  // Row sums: the 16 threads of a row group are the lanes of a half warp.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int sh = 8; sh >= 1; sh >>= 1) lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], sh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= L) continue;
    const float r = 1.f / lsum[i];
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int col = c < 4 * N64 ? 64 * (c / 4) + 4 * tx + c % 4 : 64 * N64 + RW * tx + c - 4 * N64;
      if (col < hd) out[(long)m * hd + col] = o[i][c] * r;
    }
  }
}

// The ring's stages: two where two blocks an SM still fit (each block's own
// 1 KB counted), else one where that fits, else the most that one block an
// SM takes (2 or 1); 0 for a shape with no room for one.
inline int ring_stages(int hdp, int kh, int kw) {
  for (size_t limit : {SM_SMEM / 2 - 1024, (size_t)MAX_SMEM})
    for (int st : {2, 1})
      if (smem_bytes(hdp, kh, kw, st) <= limit) return st;
  return 0;
}

// Launch on (BH, L, hd) float32 operands, hd a multiple of 4 and q, k, v
// 16-byte aligned (what the 16-byte copies take); a shape that leaves no
// room for one stage is refused.
template <bool REL>
inline int run(const void* q, const void* k, const void* v, const void* rh, const void* rw,
               void* out, int BH, int L, int hd, int kh, int kw, float q_scale,
               cudaStream_t stream) {
  if (hd % 4 != 0 || !ptc::aligned(q, 16) || !ptc::aligned(k, 16) || !ptc::aligned(v, 16))
    return (int)cudaErrorInvalidValue;
  return tc::dispatch_hdp(hd, [&](auto hdp) {
    constexpr int HDP = decltype(hdp)::value;
    const int stages = ring_stages(HDP, kh, kw);
    if (stages == 0) return (int)cudaErrorInvalidValue;
    const size_t bytes = smem_bytes(HDP, kh, kw, stages);
    const auto kernel = flash_attn_f32_kernel<HDP, REL>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + BQ - 1) / BQ, BH);
    kernel<<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(rh), static_cast<const float*>(rw), static_cast<float*>(out), L,
        hd, kh, kw, q_scale, stages);
    return (int)cudaGetLastError();
  });
}

}  // namespace f32t
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
    return has_rel ? f32t::run<true>(q, k, v, rel_h, rel_w, out, BH, L, hd, kh, kw, q_scale, s)
                   : f32t::run<false>(q, k, v, nullptr, nullptr, out, BH, L, hd, 0, 0, q_scale, s);
  return (int)cudaErrorInvalidValue;
}
