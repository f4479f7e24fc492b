// Native host-side image pipeline: decode + resample + transform + normalize.
//
// The reference feeds its GPU through torch DataLoader workers whose decode
// and transform work is native C under PIL/torchvision (reference
// data/datamgr.py:63,82 — 12 workers). This single-core TPU host gets the
// same treatment: JPEG/PNG decode (libjpeg/libpng), Pillow-compatible
// triangle-filter resampling, the reference's eval (Scale 1.15x +
// CenterCrop) and aug (RandomSizedCrop + ImageJitter + HFlip) transforms,
// and ImageNet normalisation — all in one C++ pass straight into the
// caller's float32 HWC buffer. Randomness stays in Python (numpy RNG
// parity); this layer only executes the pixel arithmetic.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

// jpeglib.h requires stdio/stddef types to be declared first
#include <jpeglib.h>
#include <png.h>

namespace {

struct ImageU8 {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h * w * 3
};

// ---------------------------------------------------------------------------
// Decoders
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, ImageU8* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, ImageU8* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // expand everything to 8-bit RGB (drop alpha against black? PIL convert
  // "RGB" drops alpha by compositing on black only for "P" etc. — for RGBA
  // it simply drops the channel, which png strip_alpha reproduces)
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = int(w);
  out->h = int(h);
  out->rgb.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, ImageU8* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// Pillow-compatible separable triangle-filter resampling (Image.BILINEAR:
// all Pillow >= 2.7 filters are antialiased convolutions whose support
// scales with the downscale factor).
// ---------------------------------------------------------------------------

struct FilterWeights {
  std::vector<int> bounds_lo;   // per output index
  std::vector<int> bounds_size;
  std::vector<float> weights;   // flattened [out, ksize]
  int ksize = 0;
};

FilterWeights triangle_weights(int in_size, int out_size, float crop_lo,
                               float crop_hi) {
  FilterWeights fw;
  double scale = double(crop_hi - crop_lo) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // triangle filter support = 1
  fw.ksize = int(std::ceil(support)) * 2 + 1;
  fw.bounds_lo.resize(out_size);
  fw.bounds_size.resize(out_size);
  fw.weights.assign(size_t(out_size) * fw.ksize, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = crop_lo + (xx + 0.5) * scale;
    int lo = std::max(int(center - support + 0.5), 0);
    int hi = std::min(int(center + support + 0.5), in_size);
    double total = 0.0;
    std::vector<double> w(hi - lo);
    for (int x = lo; x < hi; ++x) {
      double d = std::abs((x + 0.5 - center) / filterscale);
      double v = d < 1.0 ? 1.0 - d : 0.0;  // triangle
      w[x - lo] = v;
      total += v;
    }
    fw.bounds_lo[xx] = lo;
    fw.bounds_size[xx] = hi - lo;
    for (int k = 0; k < hi - lo; ++k)
      fw.weights[size_t(xx) * fw.ksize + k] = float(total > 0 ? w[k] / total : 0);
  }
  return fw;
}

// Resample the crop box [l, t, r, b] of src to out_w x out_h float RGB.
void resample(const ImageU8& src, float l, float t, float r, float b,
              int out_w, int out_h, std::vector<float>* out) {
  FilterWeights fx = triangle_weights(src.w, out_w, l, r);
  FilterWeights fy = triangle_weights(src.h, out_h, t, b);
  // horizontal pass: [src.h, out_w, 3]
  std::vector<float> tmp(size_t(src.h) * out_w * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* row = src.rgb.data() + size_t(y) * src.w * 3;
    float* trow = tmp.data() + size_t(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      int lo = fx.bounds_lo[xx], n = fx.bounds_size[xx];
      const float* w = fx.weights.data() + size_t(xx) * fx.ksize;
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + size_t(lo + k) * 3;
        acc0 += w[k] * px[0];
        acc1 += w[k] * px[1];
        acc2 += w[k] * px[2];
      }
      trow[xx * 3 + 0] = acc0;
      trow[xx * 3 + 1] = acc1;
      trow[xx * 3 + 2] = acc2;
    }
  }
  // vertical pass: [out_h, out_w, 3]
  out->assign(size_t(out_h) * out_w * 3, 0.0f);
  for (int yy = 0; yy < out_h; ++yy) {
    int lo = fy.bounds_lo[yy], n = fy.bounds_size[yy];
    const float* w = fy.weights.data() + size_t(yy) * fy.ksize;
    float* orow = out->data() + size_t(yy) * out_w * 3;
    for (int k = 0; k < n; ++k) {
      const float* trow = tmp.data() + size_t(lo + k) * out_w * 3;
      float wk = w[k];
      for (int i = 0; i < out_w * 3; ++i) orow[i] += wk * trow[i];
    }
  }
}

// ---------------------------------------------------------------------------
// PIL ImageEnhance-compatible jitter on float RGB in [0, 255]
// (reference data/additional_transforms.py:15-28: Brightness, Contrast,
// Color, each blend(degenerate, image, r)).
// ---------------------------------------------------------------------------

void jitter(std::vector<float>* img, int npx, float brightness, float contrast,
            float color) {
  float* p = img->data();
  // Brightness: degenerate = black
  if (brightness != 1.0f)
    for (int i = 0; i < npx * 3; ++i) p[i] *= brightness;
  // Contrast: degenerate = uniform mean of L (PIL rounds the mean to int)
  if (contrast != 1.0f) {
    double lsum = 0;
    for (int i = 0; i < npx; ++i)
      lsum +=
          (p[i * 3] * 299.0 + p[i * 3 + 1] * 587.0 + p[i * 3 + 2] * 114.0) /
          1000.0;
    float mean = float(int(lsum / npx + 0.5));
    for (int i = 0; i < npx * 3; ++i)
      p[i] = mean + (p[i] - mean) * contrast;
  }
  // Color: degenerate = grayscale(L)
  if (color != 1.0f) {
    for (int i = 0; i < npx; ++i) {
      float L =
          (p[i * 3] * 299.0f + p[i * 3 + 1] * 587.0f + p[i * 3 + 2] * 114.0f) /
          1000.0f;
      for (int c = 0; c < 3; ++c)
        p[i * 3 + c] = L + (p[i * 3 + c] - L) * color;
    }
  }
  for (int i = 0; i < npx * 3; ++i) p[i] = std::min(std::max(p[i], 0.0f), 255.0f);
}

// Shared work-stealing batch pool: runs one(i) for i in [0, n) over
// n_threads workers (<= 0 picks hardware_concurrency). Items are fully
// independent; workers share nothing but the counter, so results are
// deterministic and identical to a serial loop regardless of thread
// count. Returns 0 on success or the 1-based index of the first failure.
template <typename Fn>
int run_batch_pool(int n, int n_threads, const Fn& one) {
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n || err.load(std::memory_order_relaxed)) return;
      if (one(i)) {
        int expected = 0;
        err.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };
  int t = n_threads > 0 ? n_threads
                        : int(std::thread::hardware_concurrency());
  t = std::max(1, std::min(t, n));
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  for (int k = 1; k < t; ++k) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return err.load();
}

const float kMean[3] = {0.485f, 0.456f, 0.406f};
const float kStd[3] = {0.229f, 0.224f, 0.225f};

void finalize(const std::vector<float>& img, int npx, int normalize, int flip,
              int w, float* out) {
  // [0,255] float -> /255 -> (optional) ImageNet normalize, optional hflip
  int h = npx / w;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int sx = flip ? (w - 1 - x) : x;
      const float* px = img.data() + (size_t(y) * w + sx) * 3;
      float* po = out + (size_t(y) * w + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = px[c] / 255.0f;
        po[c] = normalize ? (v - kMean[c]) / kStd[c] : v;
      }
    }
  }
}

}  // namespace

extern "C" {

// Peek image dimensions without full decode work (full decode for
// simplicity; header-only would complicate the PNG/JPEG paths and decode is
// re-done by the load call anyway only when this is used standalone).
int dkt_image_size(const char* path, int* w, int* h) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  *w = img.w;
  *h = img.h;
  return 0;
}

// Eval pipeline: decode -> resize to int(size*1.15) square -> center crop
// size -> [/255, normalize] -> float32 HWC. Mirrors TransformPipeline
// aug=False (reference data/datamgr.py:32,42-46).
int dkt_load_eval(const char* path, int size, int normalize, float* out) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  int s = int(size * 1.15);
  std::vector<float> resized;
  resample(img, 0, 0, float(img.w), float(img.h), s, s, &resized);
  // center crop on the resized image
  int left = (s - size) / 2, top = (s - size) / 2;
  std::vector<float> cropped(size_t(size) * size * 3);
  for (int y = 0; y < size; ++y)
    std::memcpy(cropped.data() + size_t(y) * size * 3,
                resized.data() + (size_t(y + top) * s + left) * 3,
                size_t(size) * 3 * sizeof(float));
  finalize(cropped, size * size, normalize, 0, size, out);
  return 0;
}

// Aug pipeline with host-supplied random parameters (numpy RNG stays in
// Python for seed parity): crop box in source pixels -> resize to size ->
// jitter (brightness/contrast/color factors) -> optional hflip ->
// normalize. crop_w <= 0 requests the deterministic fallback: the centered
// min-side square (torchvision RandomSizedCrop's aspect-preserving
// Scale+CenterCrop law — same as transforms.fallback_crop_box; the Python
// caller now substitutes the box host-side, this branch is belt-and-braces).
int dkt_load_aug(const char* path, int size, int normalize, int crop_left,
                 int crop_top, int crop_w, int crop_h, float brightness,
                 float contrast, float color, int flip, float* out) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  std::vector<float> resized;
  if (crop_w <= 0) {
    int m = img.w < img.h ? img.w : img.h;
    crop_left = (img.w - m) / 2;
    crop_top = (img.h - m) / 2;
    crop_w = crop_h = m;
  }
  resample(img, float(crop_left), float(crop_top), float(crop_left + crop_w),
           float(crop_top + crop_h), size, size, &resized);
  jitter(&resized, size * size, brightness, contrast, color);
  finalize(resized, size * size, normalize, flip, size, out);
  return 0;
}

// Threaded batch eval decode: n images into out [n, size, size, 3] f32.
// A work-stealing counter feeds a pool of n_threads workers (<= 0 picks
// hardware_concurrency), so multi-core TPU hosts decode a whole split in
// parallel — the batch analogue of the reference's 12 DataLoader workers
// (reference data/datamgr.py:82). Each image is fully independent;
// decode state is per-call, so workers share nothing but the counter.
// Returns 0 on success, or the 1-based index of the first failed image.
int dkt_load_eval_batch(const char** paths, int n, int size, int normalize,
                        int n_threads, float* out) {
  const size_t stride = size_t(size) * size * 3;
  return run_batch_pool(n, n_threads, [&](int i) {
    return dkt_load_eval(paths[i], size, normalize, out + stride * i);
  });
}

// Canvas pipeline: decode -> resample the FULL image to a size x size
// square (no crop; the on-device augmentation takes random crops later —
// data/device_aug.py) -> round to uint8. The staging format of
// DeviceDataset(canvas=True).
int dkt_load_canvas(const char* path, int size, unsigned char* out) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  std::vector<float> resized;
  resample(img, 0, 0, float(img.w), float(img.h), size, size, &resized);
  const size_t npx = size_t(size) * size * 3;
  for (size_t i = 0; i < npx; ++i) {
    float v = resized[i] + 0.5f;
    out[i] = (unsigned char)(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
  }
  return 0;
}

// Threaded batch canvas decode: n images into out [n, size, size, 3] u8.
int dkt_load_canvas_batch(const char** paths, int n, int size, int n_threads,
                          unsigned char* out) {
  const size_t stride = size_t(size) * size * 3;
  return run_batch_pool(n, n_threads, [&](int i) {
    return dkt_load_canvas(paths[i], size, out + stride * i);
  });
}

}  // extern "C"
