// Antialiased separable image resampling + normalization (C++ runtime piece).
//
// The reference stack does per-sample PIL resize + torchvision Normalize on
// the Python side of the data loader (transform.py eval path; PACL utils.py) —
// the dataloader hot spot. This implements the same convolution-based
// resampling Pillow uses (scale-aware support, bilinear/bicubic kernels,
// a = -0.5) in multithreaded C++, fused with the (x/255 - mean)/std
// normalization, writing float32 channels-last ready for device_put.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kBicubicA = -0.5;

double bilinear_filter(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

double bicubic_filter(double x) {
  x = std::fabs(x);
  if (x < 1.0) return ((kBicubicA + 2.0) * x - (kBicubicA + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * kBicubicA;
  return 0.0;
}

struct Taps {
  std::vector<int> xmin;      // first source index per output position
  std::vector<int> count;     // taps per output position
  std::vector<double> weight; // flattened weights, stride = max_count
  int max_count = 0;
};

// Pillow-compatible coefficient table: support widens by the scale factor
// when downsampling (antialiasing).
Taps build_taps(int in_size, int out_size, bool bicubic) {
  const double support_base = bicubic ? 2.0 : 1.0;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = support_base * filterscale;
  const int max_count = static_cast<int>(std::ceil(support)) * 2 + 1;

  Taps taps;
  taps.xmin.resize(out_size);
  taps.count.resize(out_size);
  taps.weight.assign(static_cast<size_t>(out_size) * max_count, 0.0);
  taps.max_count = max_count;

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;

    double* w = &taps.weight[static_cast<size_t>(xx) * max_count];
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double arg = (x - center + 0.5) / filterscale;
      const double val = bicubic ? bicubic_filter(arg) : bilinear_filter(arg);
      w[x - xmin] = val;
      total += val;
    }
    if (total != 0.0) {
      for (int i = 0; i < xmax - xmin; ++i) w[i] /= total;
    }
    taps.xmin[xx] = xmin;
    taps.count[xx] = xmax - xmin;
  }
  return taps;
}

// Pillow's 8bpc fixed-point resampling (Resample.c): coefficients quantized
// to PRECISION_BITS, int32 accumulation over uint8 pixels, shift+clip back
// to uint8 after each pass. Reproducing the integer pipeline exactly makes
// the native path BIT-EXACT with PIL's img.resize on RGB images — and much
// faster than double-precision accumulation (int32 MACs vectorize).
constexpr int kPrecisionBits = 32 - 8 - 2;  // 22, as in Pillow's scalar path

inline uint8_t clip8(int v) {
  if (v >= (255 << kPrecisionBits)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

// Quantize double taps to Pillow's int coefficients (round half away from 0).
std::vector<int32_t> quantize_taps(const Taps& taps, int out_size) {
  std::vector<int32_t> kk(static_cast<size_t>(out_size) * taps.max_count, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double* w = &taps.weight[static_cast<size_t>(xx) * taps.max_count];
    int32_t* k = &kk[static_cast<size_t>(xx) * taps.max_count];
    for (int i = 0; i < taps.count[xx]; ++i) {
      const double scaled = w[i] * (1 << kPrecisionBits);
      k[i] = static_cast<int32_t>(scaled < 0 ? scaled - 0.5 : scaled + 0.5);
    }
  }
  return kk;
}

// One image: uint8 HWC -> float32 HWC resized + normalized.
void resize_one(const uint8_t* in, int in_h, int in_w, float* out, int out_h,
                int out_w, const float* mean, const float* inv_std,
                bool bicubic) {
  const Taps h_taps = build_taps(in_w, out_w, bicubic);
  const Taps v_taps = build_taps(in_h, out_h, bicubic);
  const std::vector<int32_t> h_kk = quantize_taps(h_taps, out_w);
  const std::vector<int32_t> v_kk = quantize_taps(v_taps, out_h);
  constexpr int kInit = 1 << (kPrecisionBits - 1);

  // Pass 1: horizontal -> [in_h, out_w, 3] uint8 (Pillow quantizes the
  // intermediate to 8 bits between passes; bicubic overshoot clips).
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const int32_t* k = &h_kk[static_cast<size_t>(xx) * h_taps.max_count];
      const uint8_t* px = row + static_cast<size_t>(h_taps.xmin[xx]) * 3;
      const int count = h_taps.count[xx];
      int acc0 = kInit, acc1 = kInit, acc2 = kInit;
      for (int i = 0; i < count; ++i, px += 3) {
        acc0 += k[i] * px[0];
        acc1 += k[i] * px[1];
        acc2 += k[i] * px[2];
      }
      trow[xx * 3 + 0] = clip8(acc0);
      trow[xx * 3 + 1] = clip8(acc1);
      trow[xx * 3 + 2] = clip8(acc2);
    }
  }

  // Pass 2: vertical -> [out_h, out_w, 3], fused normalize. Row-major over
  // the intermediate (contiguous loads; the tap loop is outermost per pixel
  // triple so the compiler can vectorize along x).
  std::vector<int32_t> acc(static_cast<size_t>(out_w) * 3);
  for (int yy = 0; yy < out_h; ++yy) {
    const int32_t* k = &v_kk[static_cast<size_t>(yy) * v_taps.max_count];
    const int ymin = v_taps.xmin[yy];
    const int count = v_taps.count[yy];
    std::fill(acc.begin(), acc.end(), kInit);
    for (int i = 0; i < count; ++i) {
      const uint8_t* trow =
          tmp.data() + static_cast<size_t>(ymin + i) * out_w * 3;
      const int32_t ki = k[i];
      for (int x = 0; x < out_w * 3; ++x) acc[x] += ki * trow[x];
    }
    float* orow = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      orow[xx * 3 + 0] =
          (clip8(acc[xx * 3 + 0]) / 255.0f - mean[0]) * inv_std[0];
      orow[xx * 3 + 1] =
          (clip8(acc[xx * 3 + 1]) / 255.0f - mean[1]) * inv_std[1];
      orow[xx * 3 + 2] =
          (clip8(acc[xx * 3 + 2]) / 255.0f - mean[2]) * inv_std[2];
    }
  }
}

}  // namespace

extern "C" {

// Batch of same-sized images, threaded across the batch.
void resize_normalize_batch(const uint8_t* in, int n, int in_h, int in_w,
                            float* out, int out_h, int out_w,
                            const float* mean, const float* std_dev,
                            int use_bicubic, int num_threads) {
  float inv_std[3] = {1.0f / std_dev[0], 1.0f / std_dev[1], 1.0f / std_dev[2]};
  const size_t in_stride = static_cast<size_t>(in_h) * in_w * 3;
  const size_t out_stride = static_cast<size_t>(out_h) * out_w * 3;

  if (num_threads <= 1 || n == 1) {
    for (int i = 0; i < n; ++i) {
      resize_one(in + i * in_stride, in_h, in_w, out + i * out_stride, out_h,
                 out_w, mean, inv_std, use_bicubic != 0);
    }
    return;
  }
  std::vector<std::thread> workers;
  std::atomic_int next{0};
  auto work = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      resize_one(in + i * in_stride, in_h, in_w, out + i * out_stride, out_h,
                 out_w, mean, inv_std, use_bicubic != 0);
    }
  };
  const int t = std::min(num_threads, n);
  workers.reserve(t);
  for (int i = 0; i < t; ++i) workers.emplace_back(work);
  for (auto& th : workers) th.join();
}

// Single image of arbitrary size (for ragged batches).
void resize_normalize_one(const uint8_t* in, int in_h, int in_w, float* out,
                          int out_h, int out_w, const float* mean,
                          const float* std_dev, int use_bicubic) {
  float inv_std[3] = {1.0f / std_dev[0], 1.0f / std_dev[1], 1.0f / std_dev[2]};
  resize_one(in, in_h, in_w, out, out_h, out_w, mean, inv_std,
             use_bicubic != 0);
}

}  // extern "C"
