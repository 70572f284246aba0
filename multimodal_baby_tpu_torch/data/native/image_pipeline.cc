// Native host-side image pipeline: JPEG/PNG decode + bilinear resize +
// center crop, with an internal thread pool for batch decode.
//
// This is the TPU-native replacement for the reference's per-item
// PIL/torchvision host pipeline (multimodal_data_module.py:244-274 +
// dataset __getitem__), which is the wall-clock bottleneck at high
// pairs/sec (SURVEY.md section 7.3 "host-side input pipeline throughput").
// Output is raw uint8 NHWC; normalization/augmentation run on-device.
//
// C ABI (ctypes-friendly):
//   decode_image(path, out, out_h, out_w) -> 0 on success
//   decode_batch(paths, n, out, out_h, out_w, n_threads) -> #failures
//
// Build: g++ -O3 -shared -fPIC image_pipeline.cc -ljpeg -lpng (see
// build.py). Python falls back to PIL when the library is unavailable.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB, HWC
  int h = 0, w = 0;
};

// ---------------------------------------------------------------------
// JPEG decode (libjpeg with longjmp error handling)
// ---------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// target_h/target_w > 0 enables DCT-scaled decode: libjpeg runs its
// inverse DCT at the smallest M/8 scale (M in 1..8) whose output still
// covers the target in both dims, skipping most of the IDCT + color
// conversion work (the dominant decode cost). The scaled IDCT is a
// proper frequency-domain low-pass, so the follow-up bilinear pass
// keeps its antialiasing semantics; for the common 256 -> 224 frame it
// lands exactly on 224 (M=7) and the resize pass vanishes entirely.
bool decode_jpeg(FILE* f, Image* img, int target_h, int target_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (target_h > 0 && target_w > 0) {
    int M = 8;
    while (M > 1) {
      // libjpeg output dim at scale (M-1)/8 = ceil(dim * (M-1) / 8)
      long sw = (long(cinfo.image_width) * (M - 1) + 7) / 8;
      long sh = (long(cinfo.image_height) * (M - 1) + 7) / 8;
      if (sw >= target_w && sh >= target_h) M--; else break;
    }
    cinfo.scale_num = M;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  img->w = cinfo.output_width;
  img->h = cinfo.output_height;
  img->data.resize(size_t(img->w) * img->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img->data.data() + size_t(cinfo.output_scanline) * img->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------
// PNG decode (libpng, forced to 8-bit RGB)
// ---------------------------------------------------------------------

bool decode_png(FILE* f, Image* img) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
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

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY ||
      png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  img->w = png_get_image_width(png, info);
  img->h = png_get_image_height(png, info);
  img->data.resize(size_t(img->w) * img->h * 3);
  std::vector<png_bytep> rows(img->h);
  for (int y = 0; y < img->h; y++)
    rows[y] = img->data.data() + size_t(y) * img->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------------------------------------------------------------
// PIL-compatible bilinear resize: separable triangle filter whose support
// scales with the downscale factor (antialiased), pixel-center sampling.
// Matches PIL.Image.resize(..., BILINEAR) to within rounding.
// ---------------------------------------------------------------------

struct FilterTaps {
  std::vector<int> start;      // first source index per output coord
  std::vector<int> count;      // taps per output coord
  std::vector<float> weights;  // flattened [out, max_count]
  int max_count = 0;
};

FilterTaps make_taps(int in_size, int out_size) {
  FilterTaps t;
  const float scale = float(in_size) / out_size;
  const float support = scale > 1.0f ? scale : 1.0f;  // triangle radius
  t.max_count = int(2 * support + 2);
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weights.assign(size_t(out_size) * t.max_count, 0.0f);
  for (int o = 0; o < out_size; o++) {
    const float center = (o + 0.5f) * scale;
    int lo = int(center - support + 0.5f);
    int hi = int(center + support + 0.5f);
    if (lo < 0) lo = 0;
    if (hi > in_size) hi = in_size;
    float sum = 0.0f;
    for (int j = lo; j < hi; j++) {
      float x = (j + 0.5f - center) / (scale > 1.0f ? scale : 1.0f);
      float w = x < 0 ? 1.0f + x : 1.0f - x;  // triangle
      if (w < 0) w = 0;
      t.weights[size_t(o) * t.max_count + (j - lo)] = w;
      sum += w;
    }
    if (sum > 0)
      for (int j = 0; j < hi - lo; j++)
        t.weights[size_t(o) * t.max_count + j] /= sum;
    t.start[o] = lo;
    t.count[o] = hi - lo;
  }
  return t;
}

void resize_bilinear(const Image& src, uint8_t* out, int oh, int ow) {
  const FilterTaps tx = make_taps(src.w, ow);
  const FilterTaps ty = make_taps(src.h, oh);

  // horizontal pass: [src.h, ow] float
  std::vector<float> tmp(size_t(src.h) * ow * 3);
  for (int y = 0; y < src.h; y++) {
    const uint8_t* row = &src.data[size_t(y) * src.w * 3];
    float* trow = &tmp[size_t(y) * ow * 3];
    for (int x = 0; x < ow; x++) {
      const float* w = &tx.weights[size_t(x) * tx.max_count];
      const int s = tx.start[x], n = tx.count[x];
      float acc[3] = {0, 0, 0};
      for (int j = 0; j < n; j++) {
        const uint8_t* p = row + size_t(s + j) * 3;
        acc[0] += w[j] * p[0];
        acc[1] += w[j] * p[1];
        acc[2] += w[j] * p[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }

  // vertical pass
  for (int y = 0; y < oh; y++) {
    const float* w = &ty.weights[size_t(y) * ty.max_count];
    const int s = ty.start[y], n = ty.count[y];
    uint8_t* drow = out + size_t(y) * ow * 3;
    for (int x = 0; x < ow * 3; x++) {
      float acc = 0;
      for (int j = 0; j < n; j++)
        acc += w[j] * tmp[size_t(s + j) * ow * 3 + x];
      int v = int(acc + 0.5f);
      drow[x] = v < 0 ? 0 : (v > 255 ? 255 : uint8_t(v));
    }
  }
}

// flags bit 0: DCT-scaled JPEG decode (decode at the nearest >=target
// M/8 scale instead of full size; a few u8 LSB off the full-decode +
// bilinear result, ~2-4x cheaper on downscales).
enum { kFastScale = 1 };

bool decode_one(const char* path, uint8_t* out, int oh, int ow,
                int flags = 0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);

  Image img;
  bool ok = false;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    const bool fast = (flags & kFastScale) != 0;
    ok = decode_jpeg(f, &img, fast ? oh : 0, fast ? ow : 0);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, &img);
  }
  fclose(f);
  if (!ok || img.w == 0 || img.h == 0) return false;

  if (img.h == oh && img.w == ow) {
    memcpy(out, img.data.data(), size_t(oh) * ow * 3);
  } else {
    resize_bilinear(img, out, oh, ow);
  }
  return true;
}

}  // namespace

extern "C" {

int decode_image(const char* path, uint8_t* out, int out_h, int out_w) {
  return decode_one(path, out, out_h, out_w) ? 0 : 1;
}

int decode_image_opts(const char* path, uint8_t* out, int out_h,
                      int out_w, int flags) {
  return decode_one(path, out, out_h, out_w, flags) ? 0 : 1;
}

// Returns the number of failed decodes; failed slots are zero-filled and
// (when status != nullptr) flagged status[i] = 0 so the caller can route
// them through a fallback decoder instead of silently training on black
// frames. flags: kFastScale (1) = DCT-scaled JPEG decode.
int decode_batch3(const char** paths, int n, uint8_t* out, int out_h,
                  int out_w, int n_threads, uint8_t* status, int flags) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), failures(0);
  const size_t stride = size_t(out_h) * out_w * 3;

  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + stride * i;
      bool ok = decode_one(paths[i], dst, out_h, out_w, flags);
      if (!ok) {
        memset(dst, 0, stride);
        failures.fetch_add(1);
      }
      if (status) status[i] = ok ? 1 : 0;
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failures.load();
}

int decode_batch2(const char** paths, int n, uint8_t* out, int out_h,
                  int out_w, int n_threads, uint8_t* status) {
  return decode_batch3(paths, n, out, out_h, out_w, n_threads, status, 0);
}

int decode_batch(const char** paths, int n, uint8_t* out, int out_h,
                 int out_w, int n_threads) {
  return decode_batch3(paths, n, out, out_h, out_w, n_threads, nullptr, 0);
}

}  // extern "C"
