// Native JPEG decode + TF1-bilinear resize pipeline.
//
// The training loader's host-side cost is dominated by JPEG decode plus the
// 720x1280 TF1-grid bilinear upscale of every frame
// (data/loader.py:_decode_images_parallel). The Python path runs PIL + numpy
// under a thread pool; this pipeline does the same work in one C++ thread
// pool with no GIL round-trips: libjpeg decode -> float32 bilinear resample
// on the TF1 legacy grid (src = i * in/out, NOT half-pixel centered —
// matching data/loader.py:tf1_resize_bilinear_np term-for-term so outputs
// agree to float rounding).
//
// Exposed C API (ctypes, see data/native_jpeg.py):
//   int ntm_decode_resize_batch(const char** paths, int n,
//                               int out_h, int out_w,
//                               float* out /* [n,out_h,out_w,3] */,
//                               int num_threads,
//                               char* errbuf, int errbuf_len);
// Returns 0 on success. Any per-image failure (missing file, corrupt or
// CMYK jpeg) aborts the batch with a nonzero code and a message in errbuf;
// callers fall back to the Python path.

#include <atomic>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cmath>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
  char message[JMSG_LENGTH_MAX];
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->jump, 1);
}

// decode one JPEG into an RGB uint8 buffer; returns false + message on error
bool decode_jpeg(const char* path, std::vector<unsigned char>* pixels,
                 int* height, int* width, std::string* error) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    *error = std::string("cannot open ") + path;
    return false;
  }
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    *error = std::string(path) + ": " + jerr.message;
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts grayscale/YCbCr
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  if (cinfo.output_components != 3) {
    *error = std::string(path) + ": unsupported color space";
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  pixels->resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels->data() +
        static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  *height = h;
  *width = w;
  return true;
}

// TF1 legacy-grid bilinear resize to float32 (loader.py:34-54 semantics):
//   src index = i * (in/out); corners NOT aligned; clamped at the edge.
// The arithmetic mirrors the numpy expression term-for-term in float32.
void tf1_resize(const unsigned char* src, int H, int W,
                float* dst, int out_h, int out_w) {
  if (H == out_h && W == out_w) {
    const size_t n = static_cast<size_t>(H) * W * 3;
    for (size_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
    return;
  }
  std::vector<int> x0(out_w), x1(out_w);
  std::vector<float> fx(out_w);
  const double sx = static_cast<double>(W) / out_w;
  for (int j = 0; j < out_w; ++j) {
    const double xs = j * sx;
    const double fl = std::floor(xs);
    int a = static_cast<int>(fl);
    if (a < 0) a = 0;
    if (a > W - 1) a = W - 1;
    int b = a + 1;
    if (b > W - 1) b = W - 1;
    x0[j] = a;
    x1[j] = b;
    fx[j] = static_cast<float>(xs - fl);
  }
  const double sy = static_cast<double>(H) / out_h;
  for (int i = 0; i < out_h; ++i) {
    const double ys = i * sy;
    const double fl = std::floor(ys);
    int a = static_cast<int>(fl);
    if (a < 0) a = 0;
    if (a > H - 1) a = H - 1;
    int b = a + 1;
    if (b > H - 1) b = H - 1;
    const float fy = static_cast<float>(ys - fl);
    const unsigned char* r0 = src + static_cast<size_t>(a) * W * 3;
    const unsigned char* r1 = src + static_cast<size_t>(b) * W * 3;
    float* out_row = dst + static_cast<size_t>(i) * out_w * 3;
    for (int j = 0; j < out_w; ++j) {
      const float gx = fx[j];
      const unsigned char* p00 = r0 + x0[j] * 3;
      const unsigned char* p01 = r0 + x1[j] * 3;
      const unsigned char* p10 = r1 + x0[j] * 3;
      const unsigned char* p11 = r1 + x1[j] * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] * (1.0f - gx) + p01[c] * gx;
        const float bot = p10[c] * (1.0f - gx) + p11[c] * gx;
        out_row[j * 3 + c] = top * (1.0f - fy) + bot * fy;
      }
    }
  }
}

}  // namespace

extern "C" int ntm_decode_resize_batch(
    const char** paths, int n, int out_h, int out_w, float* out,
    int num_threads, char* errbuf, int errbuf_len) {
  if (n <= 0) return 0;
  std::atomic<int> next(0);
  std::atomic<bool> failed(false);
  std::mutex err_mu;
  std::string first_error;

  auto work = [&]() {
    std::vector<unsigned char> pixels;
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      int h = 0, w = 0;
      std::string error;
      if (!decode_jpeg(paths[i], &pixels, &h, &w, &error)) {
        std::lock_guard<std::mutex> lock(err_mu);
        if (!failed.exchange(true)) first_error = error;
        return;
      }
      tf1_resize(pixels.data(), h, w,
                 out + static_cast<size_t>(i) * out_h * out_w * 3,
                 out_h, out_w);
    }
  };

  int threads = num_threads > 0 ? num_threads : 1;
  if (threads > n) threads = n;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();

  if (failed.load()) {
    std::snprintf(errbuf, errbuf_len, "%s", first_error.c_str());
    return 1;
  }
  return 0;
}
