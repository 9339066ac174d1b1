// Native data-path hot loop: threaded JPEG decode + Lanczos-3 resize.
//
// The reference framework's input pipeline spends its CPU time decoding JPEG
// chunk entries and LANCZOS-resizing them in dataloader workers
// (reference: src/dataset/dataset_re10k.py:221-229 decode,
// src/dataset/shims/crop_shim.py:14-27 resize). This module is the
// framework-native equivalent: a small C++ library driven through ctypes
// (my_depthsplat_torch/native/__init__.py), with a thread pool per batch.
// The PyTorch port's own copy of the JAX package's native/dataload.cpp.
//
// The resample replicates Pillow's 8-bit fixed-point resampler
// (libImaging/Resample.c) so outputs are bit-identical to the PIL path the
// shims otherwise use: double-precision Lanczos-3 coefficients normalized
// per output pixel, quantized to 1<<22 fixed point, accumulated per channel
// with round-half-up, horizontal pass then vertical pass through a uint8
// intermediate.
//
// Build: g++ -O3 -shared -fPIC dataload.cpp -o libdsdataload.so -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

double lanczos3(double x) {
  auto sinc = [](double v) {
    if (v == 0.0) return 1.0;
    const double p = M_PI * v;
    return std::sin(p) / p;
  };
  if (x <= -3.0 || x >= 3.0) return 0.0;
  return sinc(x) * sinc(x / 3.0);
}

// Pillow precompute_coeffs (libImaging/Resample.c) for the full-image box.
// Returns ksize; fills bounds (out_size x 2: xmin, xmax) and int coeffs
// (out_size x ksize).
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int>& kk_int) {
  const double support_base = 3.0;  // Lanczos
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = support_base * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  kk_int.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);

  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;

    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = lanczos3((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = xmax; x < ksize; ++x) k[x] = 0.0;

    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax;
    int* ki = &kk_int[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < ksize; ++x) {
      ki[x] = static_cast<int>(k[x] < 0
                                   ? k[x] * (1 << kPrecisionBits) - 0.5
                                   : k[x] * (1 << kPrecisionBits) + 0.5);
    }
  }
  return ksize;
}

// Horizontal resample (in: h x w x 3 -> out: h x ow x 3), Pillow 8bpc path.
void resample_horizontal(const uint8_t* in, int h, int w, uint8_t* out,
                         int ow, const std::vector<int>& bounds,
                         const std::vector<int>& kk_int, int ksize) {
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = in + static_cast<size_t>(yy) * w * 3;
    uint8_t* orow = out + static_cast<size_t>(yy) * ow * 3;
    for (int xx = 0; xx < ow; ++xx) {
      const int xmin = bounds[2 * xx];
      const int xmax = bounds[2 * xx + 1];
      const int* k = &kk_int[static_cast<size_t>(xx) * ksize];
      for (int c = 0; c < 3; ++c) {
        int ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x) {
          ss += row[(x + xmin) * 3 + c] * k[x];
        }
        orow[xx * 3 + c] = clip8(ss);
      }
    }
  }
}

// Vertical resample (in: h x w x 3 -> out: oh x w x 3).
void resample_vertical(const uint8_t* in, int h, int w, uint8_t* out, int oh,
                       const std::vector<int>& bounds,
                       const std::vector<int>& kk_int, int ksize) {
  for (int yy = 0; yy < oh; ++yy) {
    const int ymin = bounds[2 * yy];
    const int ymax = bounds[2 * yy + 1];
    const int* k = &kk_int[static_cast<size_t>(yy) * ksize];
    uint8_t* orow = out + static_cast<size_t>(yy) * w * 3;
    for (int xx = 0; xx < w; ++xx) {
      for (int c = 0; c < 3; ++c) {
        int ss = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < ymax; ++y) {
          ss += in[(static_cast<size_t>(y + ymin) * w + xx) * 3 + c] * k[y];
        }
        orow[xx * 3 + c] = clip8(ss);
      }
    }
  }
}

void resize_one(const uint8_t* in, int h, int w, uint8_t* out, int oh, int ow,
                uint8_t* scratch /* h x ow x 3 */) {
  std::vector<int> bounds, kk;
  const int ksh = precompute_coeffs(w, ow, bounds, kk);
  resample_horizontal(in, h, w, scratch, ow, bounds, kk, ksh);
  const int ksv = precompute_coeffs(h, oh, bounds, kk);
  resample_vertical(scratch, h, ow, out, oh, bounds, kk, ksv);
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode one JPEG into out (expected h*w*3, RGB). Returns 0 ok, 1 error,
// 2 dims mismatch, 3 corrupt-but-recoverable (libjpeg warnings).
//
// Truncated/corrupt JPEGs do NOT hit error_exit: libjpeg emits a
// premature-EOF *warning* and gray-fills the missing scanlines. PIL treats
// that as an OSError ("image file is truncated"), and the dataset hygiene
// paths (dl3dv.py's OSError skip) depend on it — so any decode that produced
// warnings is reported as a failure here, and the Python caller falls back
// to PIL, which raises the OSError the skip logic expects.
int decode_one(const uint8_t* buf, size_t len, uint8_t* out, int h, int w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  const long warnings = cinfo.err->num_warnings;
  jpeg_destroy_decompress(&cinfo);
  return warnings > 0 ? 3 : 0;
}

void parallel_for(int n, int threads, const std::function<void(int)>& fn) {
  if (threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  const int nt = std::min(threads, n);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Probe (h, w, components) of one JPEG. Returns 0 on success.
int ds_jpeg_dims(const uint8_t* buf, int64_t len, int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<size_t>(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  *c = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode n JPEGs (blob + n+1 offsets) into out (n, h, w, 3) u8 RGB.
// Returns 0 on success, or 1-based index of the first failing image.
int ds_decode_jpeg_batch(const uint8_t* blob, const int64_t* offsets, int n,
                         uint8_t* out, int h, int w, int threads) {
  std::atomic<int> fail{0};
  parallel_for(n, threads, [&](int i) {
    if (fail.load()) return;
    const uint8_t* buf = blob + offsets[i];
    const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    uint8_t* dst = out + static_cast<size_t>(i) * h * w * 3;
    if (decode_one(buf, len, dst, h, w) != 0) {
      int expected = 0;
      fail.compare_exchange_strong(expected, i + 1);
    }
  });
  return fail.load();
}

// Lanczos-3 resize (n, h, w, 3) u8 -> (n, oh, ow, 3) u8, Pillow-exact.
int ds_resize_lanczos_batch(const uint8_t* in, int n, int h, int w,
                            uint8_t* out, int oh, int ow, int threads) {
  parallel_for(n, threads, [&](int i) {
    std::vector<uint8_t> scratch(static_cast<size_t>(h) * ow * 3);
    resize_one(in + static_cast<size_t>(i) * h * w * 3, h, w,
               out + static_cast<size_t>(i) * oh * ow * 3, oh, ow,
               scratch.data());
  });
  return 0;
}

}  // extern "C"
