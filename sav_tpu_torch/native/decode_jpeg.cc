// Native JPEG decode tier for the host loader (sav_tpu_torch.data.loader).
//
// The reference's data path got its native decode from tf.data's C++
// `decode_and_crop_jpeg` op (reference: data/preprocess/preprocess.py:61-77).
// This is the same tier for the port's host loop, a copy of the JAX
// package's decode_jpeg.cc: libjpeg(-turbo)
// decode with DCT-domain scaling (the same trick as PIL's `Image.draft`),
// then a fused keep-aspect bilinear resize + center crop straight into the
// caller's fixed [S, S, 3] uint8 frame — one pass, no intermediate
// full-resolution RGB buffer allocation beyond the scaled scanlines.
//
// Exported C ABI (loaded via ctypes from sav_tpu_torch/native/__init__.py):
//   sav_decode_jpeg(data, len, decode_size, out)        -> 0 ok / <0 error
//   sav_decode_jpeg_batch(datas, lens, n, size, out, t) -> 0 ok / <0 error
//
// Unsupported inputs (CMYK/YCCK, malformed streams) return an error and the
// Python wrapper falls back to PIL, so behavior is a superset, never a
// regression.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void emit_message(j_common_ptr, int) {}  // silence warnings

// Bilinear sample of the scaled image at (sx, sy), channel c.
inline uint8_t bilinear(const uint8_t* img, int w, int h, float sx, float sy,
                        int c) {
  if (sx < 0.f) sx = 0.f;
  if (sy < 0.f) sy = 0.f;
  float mx = static_cast<float>(w - 1);
  float my = static_cast<float>(h - 1);
  if (sx > mx) sx = mx;
  if (sy > my) sy = my;
  int x0 = static_cast<int>(sx), y0 = static_cast<int>(sy);
  int x1 = x0 + 1 < w ? x0 + 1 : x0;
  int y1 = y0 + 1 < h ? y0 + 1 : y0;
  float fx = sx - x0, fy = sy - y0;
  const uint8_t* r0 = img + (static_cast<size_t>(y0) * w) * 3;
  const uint8_t* r1 = img + (static_cast<size_t>(y1) * w) * 3;
  float top = r0[x0 * 3 + c] * (1.f - fx) + r0[x1 * 3 + c] * fx;
  float bot = r1[x0 * 3 + c] * (1.f - fx) + r1[x1 * 3 + c] * fx;
  float v = top * (1.f - fy) + bot * fy;
  return static_cast<uint8_t>(v + 0.5f);
}

}  // namespace

extern "C" {

// Decode `data[0:len]` to a [decode_size, decode_size, 3] uint8 RGB frame in
// `out`: DCT-scaled decode (smallest 1/1..1/8 scale whose min dimension still
// covers 2*decode_size, mirroring decode_jpeg_fixed's draft headroom), then
// keep-aspect resize-small to decode_size + center crop, fused into one
// bilinear pass over the crop window only.
int sav_decode_jpeg(const uint8_t* data, size_t len, int decode_size,
                    uint8_t* out) {
  if (decode_size <= 0 || data == nullptr || len < 4) return -1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;

  std::vector<uint8_t> scaled;  // declared before setjmp (no leaks on jump)
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;  // corrupt / truncated stream
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }

  if (cinfo.jpeg_color_space != JCS_YCbCr &&
      cinfo.jpeg_color_space != JCS_GRAYSCALE &&
      cinfo.jpeg_color_space != JCS_RGB) {
    jpeg_destroy_decompress(&cinfo);  // CMYK/YCCK -> PIL fallback
    return -4;
  }
  cinfo.out_color_space = JCS_RGB;

  // Largest power-of-two downscale that keeps min(w,h) >= 2*decode_size.
  const int target = 2 * decode_size;
  int denom = 1;
  while (denom < 8) {
    long w = (static_cast<long>(cinfo.image_width) + 2 * denom - 1) /
             (2 * denom);
    long h = (static_cast<long>(cinfo.image_height) + 2 * denom - 1) /
             (2 * denom);
    if (w < target || h < target) break;
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned>(denom);
  cinfo.do_fancy_upsampling = FALSE;
  cinfo.dct_method = JDCT_ISLOW;

  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  if (w <= 0 || h <= 0 || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -5;
  }
  scaled.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = scaled.data() + static_cast<size_t>(cinfo.output_scanline) *
                                       w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Keep-aspect resize-small to decode_size, center crop — identical
  // geometry to _resize_center_crop (jpeg_source.py), fused: only the
  // decode_size^2 crop window is ever resampled.
  const float scale =
      static_cast<float>(decode_size) / static_cast<float>(w < h ? w : h);
  int new_w = static_cast<int>(w * scale + 0.5f);
  int new_h = static_cast<int>(h * scale + 0.5f);
  if (new_w < decode_size) new_w = decode_size;
  if (new_h < decode_size) new_h = decode_size;
  const int x0 = (new_w - decode_size) / 2;
  const int y0 = (new_h - decode_size) / 2;
  const float inv_sx = static_cast<float>(w) / new_w;
  const float inv_sy = static_cast<float>(h) / new_h;
  for (int y = 0; y < decode_size; ++y) {
    const float sy = (y0 + y + 0.5f) * inv_sy - 0.5f;
    uint8_t* orow = out + static_cast<size_t>(y) * decode_size * 3;
    for (int x = 0; x < decode_size; ++x) {
      const float sx = (x0 + x + 0.5f) * inv_sx - 0.5f;
      orow[x * 3 + 0] = bilinear(scaled.data(), w, h, sx, sy, 0);
      orow[x * 3 + 1] = bilinear(scaled.data(), w, h, sx, sy, 1);
      orow[x * 3 + 2] = bilinear(scaled.data(), w, h, sx, sy, 2);
    }
  }
  return 0;
}

// Decode n JPEGs concurrently on `nthreads` std::threads (ctypes releases
// the GIL around the call, so this parallelizes even from a single Python
// worker). out must hold n * size^2 * 3 bytes. Per-image failures are
// reported in status[i] (same codes as sav_decode_jpeg); returns the number
// of failures.
int sav_decode_jpeg_batch(const uint8_t* const* datas, const size_t* lens,
                          int n, int decode_size, uint8_t* out,
                          int* status, int nthreads) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  const size_t frame = static_cast<size_t>(decode_size) * decode_size * 3;
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += nthreads) {
        status[i] =
            sav_decode_jpeg(datas[i], lens[i], decode_size, out + i * frame);
      }
    });
  }
  for (auto& th : pool) th.join();
  int failures = 0;
  for (int i = 0; i < n; ++i) failures += status[i] != 0;
  return failures;
}

}  // extern "C"
