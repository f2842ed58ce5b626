// Native image decode + preprocess pipeline (C++ runtime piece).
//
// The reference stack decodes JPEG bytes with PIL inside Python dataloader
// workers (open_clip_train/data.py decode paths; t2v_metrics image loader) —
// at TPU serving rates (600+ img/s/chip) single-threaded Python decode is the
// end-to-end bottleneck. This implements the full host-side input pipeline in
// multithreaded C++: sniff container (JPEG/PNG/WebP) -> decode to RGB8 ->
// shortest-edge (or squash) Pillow-compatible antialiased resize -> center
// crop -> fused (x/255 - mean)/std normalize, writing float32 channels-last
// directly into the caller's pinned batch buffer.
//
// Decoding uses the same codecs Pillow wraps (libjpeg/libpng/libwebp), so the
// RGB8 pixels match PIL's decode bit-for-bit for baseline JPEG/PNG/WebP; the
// resample stage is the resize.cpp kernel already validated against PIL.
// Unusual inputs (CMYK JPEG, palette PNG with alpha quirks, animated WebP)
// return ok=0 for that slot and the Python caller falls back to PIL — the
// fast path never has to be complete, only correct where it claims ok.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <webp/decode.h>

// From resize.cpp (same shared library).
extern "C" void resize_normalize_one(const uint8_t* in, int in_h, int in_w,
                                     float* out, int out_h, int out_w,
                                     const float* mean, const float* std_dev,
                                     int use_bicubic);
// Defined below (extern "C" section).
extern "C" int probe_image(const uint8_t* data, size_t len, int* h, int* w);

namespace {

// ----------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_silence(j_common_ptr, int) {}

// scale_hint > 0 enables DCT-domain downscaled decode (libjpeg scale_denom,
// like PIL's Image.draft): decode at the smallest 1/2^k scale whose short
// edge still covers scale_hint pixels. Cuts decode+resample cost up to ~4x
// on large sources; pixels deviate slightly from a full decode, so callers
// opt in (fast_jpeg serving mode), never the parity-default path.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* h, int* w, int scale_hint) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  jerr.mgr.emit_message = jpeg_silence;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // Grayscale and YCbCr convert to RGB inside libjpeg (PIL does the same);
  // CMYK/YCCK need PIL's own conversion tables -> punt to the fallback.
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  if (scale_hint > 0) {
    const int full_short = std::min(static_cast<int>(cinfo.image_height),
                                    static_cast<int>(cinfo.image_width));
    int denom = 1;
    while (denom < 8 && full_short / (denom * 2) >= scale_hint) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned>(denom);
  }
  jpeg_start_decompress(&cinfo);
  const int out_w = static_cast<int>(cinfo.output_width);
  const int out_h = static_cast<int>(cinfo.output_height);
  if (out_w <= 0 || out_h <= 0 || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  rgb->resize(static_cast<size_t>(out_h) * out_w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() +
                   static_cast<size_t>(cinfo.output_scanline) * out_w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *h = out_h;
  *w = out_w;
  return true;
}

// ------------------------------------------------------------------ PNG ----

bool decode_png(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                int* h, int* w) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, len)) return false;
  // RGB output; libpng composites 16-bit/palette/gray for us. Alpha is
  // dropped the way PIL's convert("RGB") drops it (no compositing against
  // a background) only when the image has no alpha — with alpha, PIL and a
  // naive strip disagree, so route alpha images to the fallback.
  if (image.format & PNG_FORMAT_FLAG_ALPHA) {
    png_image_free(&image);
    return false;
  }
  image.format = PNG_FORMAT_RGB;
  const size_t size = PNG_IMAGE_SIZE(image);
  if (size == 0) {
    png_image_free(&image);
    return false;
  }
  rgb->resize(size);
  if (!png_image_finish_read(&image, nullptr, rgb->data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  *h = static_cast<int>(image.height);
  *w = static_cast<int>(image.width);
  return true;
}

// ----------------------------------------------------------------- WebP ----

bool decode_webp(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* h, int* w) {
  WebPBitstreamFeatures feat;
  if (WebPGetFeatures(data, len, &feat) != VP8_STATUS_OK) return false;
  if (feat.has_animation || feat.has_alpha) return false;  // fallback path
  rgb->resize(static_cast<size_t>(feat.width) * feat.height * 3);
  if (WebPDecodeRGBInto(data, len, rgb->data(), rgb->size(),
                        feat.width * 3) == nullptr) {
    return false;
  }
  *h = feat.height;
  *w = feat.width;
  return true;
}

// ---------------------------------------------------------------- driver ---

bool decode_any(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                int* h, int* w, int jpeg_scale_hint) {
  if (len < 12) return false;
  if (data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, rgb, h, w, jpeg_scale_hint);
  if (data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' && data[3] == 'G')
    return decode_png(data, len, rgb, h, w);
  if (std::memcmp(data, "RIFF", 4) == 0 && std::memcmp(data + 8, "WEBP", 4) == 0)
    return decode_webp(data, len, rgb, h, w);
  return false;
}

// Decompression-bomb guard: mirror PIL's MAX_IMAGE_PIXELS default (~89 MP);
// anything larger defers to the Python fallback (which applies PIL's own
// bomb policy) instead of attempting a multi-GB allocation here.
constexpr int64_t kMaxPixels = 89478485;

// One sample: encoded bytes -> out[S,S,3] float32 normalized.
bool process_one(const uint8_t* data, size_t len, float* out, int image_size,
                 const float* mean, const float* std_dev, int bicubic,
                 int shortest_edge, int fast_jpeg) try {
  {
    int ph = 0, pw = 0;
    if (probe_image(data, len, &ph, &pw) &&
        static_cast<int64_t>(ph) * pw > kMaxPixels) {
      return false;
    }
  }
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_any(data, len, &rgb, &h, &w, fast_jpeg ? image_size : 0))
    return false;

  if (!shortest_edge || (h == w)) {
    // Squash (or already square): resize straight into the output slot.
    resize_normalize_one(rgb.data(), h, w, out, image_size, image_size, mean,
                         std_dev, bicubic);
    return true;
  }
  // Shortest-edge resize + center crop (the CLIP eval transform geometry).
  // torchvision _compute_resized_output_size TRUNCATES the long edge
  // (int(), no rounding) and center_crop rounds half-to-even (Python
  // round()) — both reproduced exactly (image/preprocess.py _resize_shortest
  // / _center_crop are the validated Python counterparts).
  int new_h, new_w;
  if (h <= w) {
    new_h = image_size;
    new_w = std::max(
        static_cast<int>(static_cast<double>(image_size) * w / h), image_size);
  } else {
    new_w = image_size;
    new_h = std::max(
        static_cast<int>(static_cast<double>(image_size) * h / w), image_size);
  }
  std::vector<float> resized(static_cast<size_t>(new_h) * new_w * 3);
  resize_normalize_one(rgb.data(), h, w, resized.data(), new_h, new_w, mean,
                       std_dev, bicubic);
  // nearbyint under the default FP environment rounds half-to-even, matching
  // Python round().
  const int top =
      static_cast<int>(std::nearbyint((new_h - image_size) / 2.0));
  const int left =
      static_cast<int>(std::nearbyint((new_w - image_size) / 2.0));
  for (int y = 0; y < image_size; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * image_size * 3,
                resized.data() +
                    (static_cast<size_t>(top + y) * new_w + left) * 3,
                static_cast<size_t>(image_size) * 3 * sizeof(float));
  }
  return true;
} catch (...) {
  // bad_alloc (hostile header) or any codec-side throw: honor the ok=0
  // fallback contract rather than letting the exception escape a worker
  // thread (std::terminate would kill the whole process).
  return false;
}

}  // namespace

extern "C" {

// Probe decoded dimensions without a full decode (header sniff).
// Returns 1 on success.
int probe_image(const uint8_t* data, size_t len, int* h, int* w) {
  if (len < 12) return 0;
  if (data[0] == 0xFF && data[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_error_exit;
    jerr.mgr.emit_message = jpeg_silence;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      return 0;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    const int ok = jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK;
    if (ok) {
      *h = static_cast<int>(cinfo.image_height);
      *w = static_cast<int>(cinfo.image_width);
    }
    jpeg_destroy_decompress(&cinfo);
    return ok;
  }
  if (data[0] == 0x89 && data[1] == 'P') {
    png_image image;
    std::memset(&image, 0, sizeof(image));
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, data, len)) return 0;
    *h = static_cast<int>(image.height);
    *w = static_cast<int>(image.width);
    png_image_free(&image);
    return 1;
  }
  if (std::memcmp(data, "RIFF", 4) == 0 &&
      std::memcmp(data + 8, "WEBP", 4) == 0) {
    return WebPGetInfo(data, len, w, h) ? 1 : 0;
  }
  return 0;
}

// Decode + preprocess a batch of encoded images, threaded across the batch.
//
//   bufs/lens : n encoded byte buffers
//   out       : [n, image_size, image_size, 3] float32 (written in place)
//   ok        : [n] uint8, 1 = slot valid, 0 = caller must fall back (PIL)
//   shortest_edge : 1 = shortest-edge resize + center crop, 0 = squash
//   fast_jpeg : 1 = DCT-domain downscaled JPEG decode (serving mode; pixels
//               deviate slightly from the PIL-exact full decode)
//
// Returns the number of failed slots (their out memory is left untouched).
int decode_preprocess_batch(const uint8_t* const* bufs, const size_t* lens,
                            int n, float* out, int image_size,
                            const float* mean, const float* std_dev,
                            int use_bicubic, int shortest_edge, int fast_jpeg,
                            int num_threads, uint8_t* ok) {
  const size_t out_stride =
      static_cast<size_t>(image_size) * image_size * 3;
  std::atomic_int failures{0};
  auto run_one = [&](int i) {
    const bool good =
        process_one(bufs[i], lens[i], out + i * out_stride, image_size, mean,
                    std_dev, use_bicubic, shortest_edge, fast_jpeg);
    ok[i] = good ? 1 : 0;
    if (!good) failures.fetch_add(1);
  };

  if (num_threads <= 1 || n == 1) {
    for (int i = 0; i < n; ++i) run_one(i);
    return failures.load();
  }
  std::vector<std::thread> workers;
  std::atomic_int next{0};
  auto work = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      run_one(i);
    }
  };
  const int t = std::min(num_threads, n);
  workers.reserve(t);
  for (int i = 0; i < t; ++i) workers.emplace_back(work);
  for (auto& th : workers) th.join();
  return failures.load();
}

}  // extern "C"
