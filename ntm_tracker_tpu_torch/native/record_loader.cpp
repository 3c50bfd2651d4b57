// Parallel frame-record loader: the host-side hot path of the data layer.
//
// Replaces the reference's TF queue-runner record pipeline
// (TextLineReader + decode_csv + FixedLengthRecordReader,
// direct_offset_output.py:159-224) with a native thread-pool reader that
// parses the per-frame ".txt" metadata and ".bin" float64 heatmaps for a
// whole batch in parallel, off the Python GIL. JPEG decode stays in PIL
// (already native); this covers the many-small-files metadata side, which
// Python's per-file open/parse dominates at large batch sizes.
//
// C ABI (ctypes):
//   int load_records(const char** paths, int n, int gt_elems,
//                    float* cropboxes /* n*4 */,
//                    float* bboxes    /* n*4 */,
//                    float* offsets   /* n*2 (y,x) */,
//                    float* gts       /* n*gt_elems, float64->float32 */,
//                    char* img_paths  /* n*1024 */,
//                    int num_threads);
// Returns 0 on success, else the (1-based) index of the first failing record.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kImgPathCap = 1024;

bool load_one(const char* path, int gt_elems, float* cropbox, float* bbox,
              float* offsets, float* gt, char* img_path) {
  // --- <path>.txt : y1,x1,y2,x2,by1,bx1,by2,bx2,image_path,dy,dx ----------
  std::string txt = std::string(path) + ".txt";
  FILE* f = std::fopen(txt.c_str(), "rb");
  if (!f) return false;
  char buf[4096];
  // reject records LARGER than the buffer (reading would truncate
  // mid-field, e.g. clipping the trailing dx's digits into a silently
  // wrong offset); a record exactly filling the buffer is still valid
  std::fseek(f, 0, SEEK_END);
  long txt_size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (txt_size <= 0 || txt_size > static_cast<long>(sizeof(buf)) - 1) {
    std::fclose(f);
    return false;
  }
  size_t got = std::fread(buf, 1, txt_size, f);
  std::fclose(f);
  if (got != static_cast<size_t>(txt_size)) return false;
  buf[got] = '\0';

  // split on commas; the image path itself contains no commas (the writer
  // uses the same contract, preprocess.py:329-334)
  std::vector<char*> fields;
  char* save = nullptr;
  for (char* tok = strtok_r(buf, ",", &save); tok;
       tok = strtok_r(nullptr, ",", &save)) {
    fields.push_back(tok);
  }
  if (fields.size() != 11) return false;
  for (int i = 0; i < 4; ++i) cropbox[i] = std::strtof(fields[i], nullptr);
  for (int i = 0; i < 4; ++i) bbox[i] = std::strtof(fields[4 + i], nullptr);
  // an over-cap image path would be silently clipped by snprintf -> a
  // wrong file opened downstream; reject instead
  if (std::strlen(fields[8]) >= kImgPathCap) return false;
  std::snprintf(img_path, kImgPathCap, "%s", fields[8]);
  offsets[0] = std::strtof(fields[9], nullptr);   // y
  offsets[1] = std::strtof(fields[10], nullptr);  // x

  // --- <path>.bin : gt_elems float64 -> float32 ---------------------------
  std::string bin = std::string(path) + ".bin";
  f = std::fopen(bin.c_str(), "rb");
  if (!f) return false;
  // the record must be EXACTLY gt_elems doubles — a larger file means the
  // caller's gt_width disagrees with how the dataset was preprocessed, and
  // silently truncating would train on scrambled heatmaps (the Python
  // reader raises on the same mismatch)
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize != static_cast<long>(gt_elems) * 8) {
    std::fclose(f);
    return false;
  }
  std::vector<double> tmp(gt_elems);
  size_t rd = std::fread(tmp.data(), sizeof(double), gt_elems, f);
  std::fclose(f);
  if (rd != static_cast<size_t>(gt_elems)) return false;
  for (int i = 0; i < gt_elems; ++i) gt[i] = static_cast<float>(tmp[i]);
  return true;
}

}  // namespace

extern "C" int load_records(const char** paths, int n, int gt_elems,
                            float* cropboxes, float* bboxes, float* offsets,
                            float* gts, char* img_paths, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      if (!load_one(paths[i], gt_elems, cropboxes + 4 * i, bboxes + 4 * i,
                    offsets + 2 * i, gts + static_cast<int64_t>(gt_elems) * i,
                    img_paths + static_cast<int64_t>(kImgPathCap) * i)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };

  std::vector<std::thread> threads;
  int nt = std::min(num_threads, n);
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}
