// host_runtime — the port's native host-side ops, bound with ctypes by
// sam_quantization_tpu_torch/native.py and built with g++ at first use.
//
// These are the host loops around the card's work:
//   * COCO uncompressed RLE encode/decode, single, batched and bit-packed
//     (for automatic mask generation);
//   * greedy box NMS (torchvision batched_nms counterpart);
//   * exact Euclidean distance transform (cv2.distanceTransform
//     counterpart, Felzenszwalb-Huttenlocher two-pass), used by the
//     click-loop evaluation's Clicker;
//   * block-planar packing of integer weight grids (nn/packed.py's layout).
//
// A copy of the same ops of the repository's csrc/samq_runtime.cpp, so the
// port needs nothing of the JAX package. Plain C ABI, no Python.h.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>
#include <limits>

namespace {

// 128x128 blocked transpose of a row-major HxW mask into a column-major
// scratch: each block's reads and writes both stay L1-resident, vs the
// naive column-major walk whose every read misses (stride = w bytes).
void transpose_cm(const uint8_t* mask, int64_t h, int64_t w, uint8_t* cm) {
  const int64_t B = 128;
  for (int64_t x0 = 0; x0 < w; x0 += B) {
    int64_t x1 = std::min(x0 + B, w);
    for (int64_t y0 = 0; y0 < h; y0 += B) {
      int64_t y1 = std::min(y0 + B, h);
      for (int64_t x = x0; x < x1; ++x)
        for (int64_t y = y0; y < y1; ++y)
          // normalized to exactly 0/1 so the scan's word-compare fast
          // path below is sound for any nonzero input convention
          cm[x * h + y] = mask[y * w + x] != 0;
    }
  }
}

// linear run scan over the column-major scratch (runs start with zeros).
// Mask runs are long (a blob of radius r has ~2r runs in a 1M-pixel
// image), so the scan skips 8 normalized bytes per iteration while the
// word matches the current run value — ~15x fewer loop steps on real
// AMG masks than the byte loop.
int64_t scan_runs(const uint8_t* cm, int64_t total, int64_t* out_counts,
                  int64_t cap) {
  const uint64_t kOnes = 0x0101010101010101ull;
  int64_t n = 0;
  uint8_t cur = 0;
  int64_t run = 0;
  int64_t i = 0;
  while (i < total) {
    uint64_t want = cur ? kOnes : 0;
    while (i + 8 <= (int64_t)total) {
      uint64_t wv;
      std::memcpy(&wv, cm + i, 8);
      if (wv != want) break;
      run += 8;
      i += 8;
    }
    if (i >= total) break;
    uint8_t v = cm[i];
    if (v == cur) {
      ++run;
    } else {
      if (n >= cap) return -1;
      out_counts[n++] = run;
      cur = v;
      run = 1;
    }
    ++i;
  }
  if (n >= cap) return -1;
  out_counts[n++] = run;
  return n;
}

int64_t rle_encode_cm(const uint8_t* mask, int64_t h, int64_t w, uint8_t* cm,
                      int64_t* out_counts, int64_t cap) {
  transpose_cm(mask, h, w, cm);
  return scan_runs(cm, h * w, out_counts, cap);
}

}  // namespace

extern "C" {

// --------------------------------------------------------------------------
// RLE encode: column-major (Fortran) runs starting with count of zeros.
// mask: HxW uint8 (row-major). out_counts: caller-allocated buffer of
// capacity cap; returns number of counts written, or -1 if cap too small.
// --------------------------------------------------------------------------
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   int64_t* out_counts, int64_t cap) {
  std::vector<uint8_t> cm((size_t)(h * w));
  return rle_encode_cm(mask, h, w, cm.data(), out_counts, cap);
}

// --------------------------------------------------------------------------
// Batched RLE encode over N stacked HxW masks, threaded (the AMG host
// loop encodes points_per_batch * 3 full-res masks per device batch).
// out_counts: N x cap_per; out_lens[i] = counts written for mask i.
// Returns 0, or -1 if any mask overflowed cap_per.
// --------------------------------------------------------------------------
int64_t rle_encode_batch(const uint8_t* masks, int64_t n, int64_t h,
                         int64_t w, int64_t* out_counts, int64_t cap_per,
                         int64_t* out_lens, int64_t nthreads) {
  if (n <= 0) return 0;
  int64_t hw = std::max<int64_t>(
      1, std::min<int64_t>(std::thread::hardware_concurrency(), 16));
  int64_t nt = std::max<int64_t>(1, std::min(nthreads > 0 ? nthreads : hw, n));
  std::atomic<int64_t> next(0);
  std::atomic<bool> overflow(false);
  auto worker = [&]() {
    std::vector<uint8_t> cm((size_t)(h * w));
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t m = rle_encode_cm(masks + i * h * w, h, w, cm.data(),
                                out_counts + i * cap_per, cap_per);
      out_lens[i] = m;
      if (m < 0) overflow.store(true);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return overflow.load() ? -1 : 0;
}

// --------------------------------------------------------------------------
// Batched RLE encode over N masks BIT-PACKED on the device (8x smaller
// device->host transfer). Layout per mask: w columns x ceil(h/8) bytes, bit
// j of byte b = row b*8+j (little bit order: numpy's packbits(transpose(
// mask), axis=-1, bitorder='little')) — i.e. the COLUMN-MAJOR bit stream COCO RLE scans, so
// the runs are scanned straight off the packed bytes with a byte-skip fast
// path (a 0x00/0xFF byte extends the current run by 8 without touching
// bits). No unpacked mask is ever materialized.
// --------------------------------------------------------------------------
namespace {

int64_t scan_runs_packed_col(const uint8_t* packed, int64_t h, int64_t w,
                             int64_t* out_counts, int64_t cap) {
  const int64_t bpc = (h + 7) / 8;  // bytes per column
  int64_t n = 0;
  uint8_t cur = 0;
  int64_t run = 0;
  for (int64_t x = 0; x < w; ++x) {
    const uint8_t* col = packed + x * bpc;
    int64_t bits_left = h;
    for (int64_t b = 0; b < bpc; ++b) {
      uint8_t v = col[b];
      int nb = bits_left >= 8 ? 8 : (int)bits_left;
      if (nb == 8 && v == (cur ? 0xFF : 0x00)) {
        run += 8;
        bits_left -= 8;
        continue;
      }
      for (int j = 0; j < nb; ++j) {
        uint8_t bit = (v >> j) & 1;
        if (bit == cur) {
          ++run;
        } else {
          if (n >= cap) return -1;
          out_counts[n++] = run;
          cur = bit;
          run = 1;
        }
      }
      bits_left -= nb;
    }
  }
  if (n >= cap) return -1;
  out_counts[n++] = run;
  return n;
}

}  // namespace

int64_t rle_encode_batch_packed(const uint8_t* packed, int64_t n, int64_t h,
                                int64_t w, int64_t* out_counts,
                                int64_t cap_per, int64_t* out_lens,
                                int64_t nthreads) {
  if (n <= 0) return 0;
  const int64_t per_mask = w * ((h + 7) / 8);
  int64_t hw = std::max<int64_t>(
      1, std::min<int64_t>(std::thread::hardware_concurrency(), 16));
  int64_t nt = std::max<int64_t>(1, std::min(nthreads > 0 ? nthreads : hw, n));
  std::atomic<int64_t> next(0);
  std::atomic<bool> overflow(false);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t m = scan_runs_packed_col(packed + i * per_mask, h, w,
                                       out_counts + i * cap_per, cap_per);
      out_lens[i] = m;
      if (m < 0) overflow.store(true);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return overflow.load() ? -1 : 0;
}

// RLE decode into HxW uint8 row-major.
void rle_decode(const int64_t* counts, int64_t n_counts, int64_t h, int64_t w,
                uint8_t* out_mask) {
  int64_t idx = 0;
  uint8_t parity = 0;
  std::vector<uint8_t> flat((size_t)h * w);
  for (int64_t i = 0; i < n_counts; ++i) {
    int64_t c = counts[i];
    if (idx + c > h * w) c = h * w - idx;
    std::memset(flat.data() + idx, parity, (size_t)c);
    idx += c;
    parity = !parity;
  }
  // flat is column-major; transpose to row-major
  for (int64_t x = 0; x < w; ++x)
    for (int64_t y = 0; y < h; ++y)
      out_mask[y * w + x] = flat[x * h + y];
}

int64_t rle_area(const int64_t* counts, int64_t n_counts) {
  int64_t area = 0;
  for (int64_t i = 1; i < n_counts; i += 2) area += counts[i];
  return area;
}

// --------------------------------------------------------------------------
// Greedy IoU NMS. boxes: N x 4 (x1, y1, x2, y2) float32, scores: N float32.
// order is computed internally (descending score, stable). keep_out: caller
// buffer of capacity N; returns number kept.
// --------------------------------------------------------------------------
int64_t box_nms(const float* boxes, const float* scores, int64_t n,
                float iou_threshold, int64_t* keep_out) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return scores[a] > scores[b]; });
  std::vector<uint8_t> suppressed(n, 0);
  std::vector<float> areas(n);
  for (int64_t i = 0; i < n; ++i) {
    float wdt = std::max(0.f, boxes[i * 4 + 2] - boxes[i * 4 + 0]);
    float hgt = std::max(0.f, boxes[i * 4 + 3] - boxes[i * 4 + 1]);
    areas[i] = wdt * hgt;
  }
  int64_t n_keep = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float* bi = boxes + i * 4;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      int64_t j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + j * 4;
      float xx1 = std::max(bi[0], bj[0]);
      float yy1 = std::max(bi[1], bj[1]);
      float xx2 = std::min(bi[2], bj[2]);
      float yy2 = std::min(bi[3], bj[3]);
      float inter = std::max(0.f, xx2 - xx1) * std::max(0.f, yy2 - yy1);
      float iou = inter / std::max(areas[i] + areas[j] - inter, 1e-9f);
      if (iou > iou_threshold) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// --------------------------------------------------------------------------
// Exact EDT (Felzenszwalb & Huttenlocher), squared distances then sqrt.
// mask: HxW uint8; nonzero cells get distance to the nearest zero cell.
// out: HxW float32.
// --------------------------------------------------------------------------
static void edt_1d(const float* f, float* d, int n, std::vector<int>& v,
                   std::vector<float>& z) {
  int k = 0;
  v[0] = 0;
  z[0] = -std::numeric_limits<float>::infinity();
  z[1] = std::numeric_limits<float>::infinity();
  for (int q = 1; q < n; ++q) {
    float s;
    while (true) {
      s = ((f[q] + q * (float)q) - (f[v[k]] + v[k] * (float)v[k])) /
          (2.f * q - 2.f * v[k]);
      if (s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = std::numeric_limits<float>::infinity();
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    float dq = q - (float)v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

void distance_transform_edt(const uint8_t* mask, int64_t h, int64_t w,
                            float* out) {
  const float INF = 1e20f;
  std::vector<float> g((size_t)h * w);
  for (int64_t i = 0; i < h * w; ++i) g[i] = mask[i] ? INF : 0.f;
  std::vector<int> v((size_t)std::max(h, w) + 1);
  std::vector<float> z((size_t)std::max(h, w) + 2);
  std::vector<float> f((size_t)std::max(h, w));
  std::vector<float> d((size_t)std::max(h, w));
  // columns
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y) f[y] = g[y * w + x];
    edt_1d(f.data(), d.data(), (int)h, v, z);
    for (int64_t y = 0; y < h; ++y) g[y * w + x] = d[y];
  }
  // rows
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) f[x] = g[y * w + x];
    edt_1d(f.data(), d.data(), (int)w, v, z);
    for (int64_t x = 0; x < w; ++x) out[y * w + x] = std::sqrt(d[x]);
  }
}

// Pack an integer grid w (K, N), values in [0, 2^bits), into block-planar
// int32 words out (K / per, N), per = 32 / bits (bits 2, 4, 8): K is cut
// into pack blocks of pack_block rows, and word row blk * rpp + i (rpp =
// pack_block / per) holds rows blk * pack_block + s * rpp + i, s = 0..per-1,
// at bit s * bits.
void pack_block_planar(const int32_t* w, int64_t K, int64_t N, int bits,
                       int pack_block, int32_t* out) {
  const int per = 32 / bits;
  const int rows_per_plane = pack_block / per;
  std::memset(out, 0, sizeof(int32_t) * (size_t)(K / per) * N);
  for (int64_t k = 0; k < K; ++k) {
    const int64_t blk = k / pack_block, in_blk = k % pack_block;
    const int plane = (int)(in_blk / rows_per_plane);
    const int64_t row = blk * rows_per_plane + in_blk % rows_per_plane;
    const uint32_t shift = (uint32_t)(plane * bits);
    const int32_t* src = w + k * N;
    int32_t* dst = out + row * N;
    for (int64_t n = 0; n < N; ++n)
      dst[n] = (int32_t)((uint32_t)dst[n] | ((uint32_t)src[n] << shift));
  }
}

}  // extern "C"
