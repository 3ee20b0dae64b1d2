// Native data-loading runtime (port of detzero_tpu/native/loader.cpp,
// unchanged but for these comments and the TFRecord checksum at the end,
// `masked_crc32c`, which data/tfrecord_io.py frames records with).
//
// Replaces the reference's torch-DataLoader C++ worker pool for the hot host
// path: reading per-frame .npy point files, filtering no-label-zone points,
// tanh-compressing intensity, rigid-transforming sweeps into the current
// frame, appending the time-offset channel, and padding to the fixed XLA
// point budget — all in parallel C++ threads, no Python in the loop.
//
// Plain C ABI (ctypes-friendly): the Python wrapper owns all allocations.
//
// Built by native/__init__.py (g++ -O3 -shared -fPIC -std=c++17 ... -lpthread)
// into build/detzero_tpu_torch_native/<hash>/ at the root of the checkout.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Minimal .npy reader for C-contiguous little-endian float32 2-D arrays.
// Returns rows/cols and fills `out` (malloc'd, caller frees via free_buffer).
bool read_npy_f32(const char* path, float** out, int64_t* rows, int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(f);
    return false;
  }
  uint32_t header_len = 0;
  if (magic[6] == 1) {
    uint16_t h16;
    if (std::fread(&h16, 2, 1, f) != 1) { std::fclose(f); return false; }
    header_len = h16;
  } else {
    if (std::fread(&header_len, 4, 1, f) != 1) { std::fclose(f); return false; }
  }
  std::string header(header_len, '\0');
  if (std::fread(header.data(), 1, header_len, f) != header_len) {
    std::fclose(f);
    return false;
  }
  if (header.find("'<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    std::fclose(f);
    return false;  // only C-order float32 supported
  }
  auto sp = header.find("'shape':");
  auto lp = header.find('(', sp);
  auto rp = header.find(')', lp);
  int64_t r = 0, c = 1;
  if (std::sscanf(header.substr(lp + 1, rp - lp - 1).c_str(),
                  "%ld, %ld", &r, &c) < 1) {
    std::fclose(f);
    return false;
  }
  float* buf = static_cast<float*>(std::malloc(sizeof(float) * r * c));
  if (std::fread(buf, sizeof(float), r * c, f) != size_t(r * c)) {
    std::free(buf);
    std::fclose(f);
    return false;
  }
  std::fclose(f);
  *out = buf;
  *rows = r;
  *cols = c;
  return true;
}

// Process one sweep into the output buffer region starting at `write_pos`.
// rel: 4x4 row-major transform (cur_pose^-1 @ sweep_pose).
// in cols: [x y z intensity elongation nlz]; out cols:
// [x y z tanh(intensity) elongation dt]. Returns rows written.
int64_t process_sweep(const float* in, int64_t rows, int64_t cols,
                      const float* rel, float dt, int nlz_col,
                      int intensity_col, float* out, int64_t out_stride,
                      int64_t capacity) {
  int64_t w = 0;
  for (int64_t i = 0; i < rows && w < capacity; ++i) {
    const float* p = in + i * cols;
    if (nlz_col >= 0 && nlz_col < cols && p[nlz_col] != -1.0f) continue;
    float x = p[0], y = p[1], z = p[2];
    float* o = out + w * out_stride;
    o[0] = rel[0] * x + rel[1] * y + rel[2] * z + rel[3];
    o[1] = rel[4] * x + rel[5] * y + rel[6] * z + rel[7];
    o[2] = rel[8] * x + rel[9] * y + rel[10] * z + rel[11];
    int oc = 3;
    for (int c = 3; c < cols; ++c) {
      if (c == nlz_col) continue;
      float v = p[c];
      if (c == intensity_col) v = std::tanh(v);
      if (oc < out_stride - 1) o[oc++] = v;
    }
    o[out_stride - 1] = dt;
    ++w;
  }
  return w;
}

}  // namespace

extern "C" {

void free_buffer(float* p) { std::free(p); }

// Load one multi-sweep sample: n_sweeps files merged into `out`
// (budget x out_stride, pre-allocated by the caller, zero-padded here).
// rels: n_sweeps flattened 4x4 transforms; dts: per-sweep time offsets.
// Returns total valid rows, or -1 on any read failure.
int64_t load_merged_sample(const char** paths, int64_t n_sweeps,
                           const float* rels, const float* dts, int nlz_col,
                           int intensity_col, float* out, int64_t out_stride,
                           int64_t budget) {
  std::memset(out, 0, sizeof(float) * budget * out_stride);
  int64_t total = 0;
  for (int64_t s = 0; s < n_sweeps; ++s) {
    float* buf = nullptr;
    int64_t rows = 0, cols = 0;
    if (!read_npy_f32(paths[s], &buf, &rows, &cols)) return -1;
    total += process_sweep(buf, rows, cols, rels + 16 * s, dts[s], nlz_col,
                           intensity_col, out + total * out_stride, out_stride,
                           budget - total);
    std::free(buf);
    if (total >= budget) break;
  }
  return total;
}

// Batched parallel variant: one worker thread per sample (up to n_threads).
// paths is a flat array of (batch * max_sweeps) C strings ("" = unused slot).
// Returns 0 on success; per-sample valid counts in n_valid.
int32_t load_batch(const char** paths, const int64_t* sweeps_per_sample,
                   int64_t batch, int64_t max_sweeps, const float* rels,
                   const float* dts, int nlz_col, int intensity_col,
                   float* out, int64_t out_stride, int64_t budget,
                   int64_t* n_valid, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int32_t> failed(0);
  auto worker = [&]() {
    while (true) {
      int64_t b = next.fetch_add(1);
      if (b >= batch) break;
      int64_t n = load_merged_sample(
          paths + b * max_sweeps, sweeps_per_sample[b], rels + b * max_sweeps * 16,
          dts + b * max_sweeps, nlz_col, intensity_col,
          out + b * budget * out_stride, out_stride, budget);
      if (n < 0) failed.store(1);
      n_valid[b] = n < 0 ? 0 : n;
    }
  };
  int64_t nt = n_threads < 1 ? 1 : (n_threads > batch ? batch : n_threads);
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failed.load();
}

// ---------------------------------------------------------------------
// Per-object point cropping — the daemon's prepare_object_data hot loop
// (reference analog: roiaware_pool3d points_in_boxes CUDA kernel). For
// each of m enlarged rotated boxes, select the frame points inside it
// (canonical transform + axis test, same epsilon as ops/box_np) and pack
// selections consecutively per box. Two-pass ctypes API:
//   pass 1 (out == nullptr): fill counts only, return total rows;
//   pass 2: offsets = exclusive prefix sums of counts; fill out; returns
//   total rows written (call with capacity >= pass-1 total).
// Threaded over boxes (each box scans all n points independently).
int64_t crop_points_multi(const float* pts, int64_t n, int64_t stride,
                          const float* boxes, int64_t m, double enlarge,
                          const int64_t* offsets, float* out,
                          int64_t* counts, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t j = next.fetch_add(1);
      if (j >= m) break;
      const float* b = boxes + j * 7;
      const double cx = b[0], cy = b[1], cz = b[2];
      const double hx = b[3] * enlarge / 2.0 + 1e-6;
      const double hy = b[4] * enlarge / 2.0 + 1e-6;
      const double hz = b[5] * enlarge / 2.0 + 1e-6;
      const double c = std::cos(-(double)b[6]), s = std::sin(-(double)b[6]);
      float* dst = out ? out + offsets[j] * stride : nullptr;
      int64_t cnt = 0;
      for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + i * stride;
        const double dx = p[0] - cx, dy = p[1] - cy, dz = p[2] - cz;
        const double lx = dx * c - dy * s;
        const double ly = dx * s + dy * c;
        if (std::fabs(lx) <= hx && std::fabs(ly) <= hy &&
            std::fabs(dz) <= hz) {
          if (dst) std::memcpy(dst + cnt * stride, p, stride * sizeof(float));
          ++cnt;
        }
      }
      counts[j] = cnt;
    }
  };
  int64_t nt = n_threads < 1 ? 1 : (n_threads > m ? m : n_threads);
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  int64_t total = 0;
  for (int64_t j = 0; j < m; ++j) total += counts[j];
  return total;
}

// TFRecord's checksum: CRC-32C (Castagnoli, reflected polynomial
// 0x82F63B78) of n bytes, masked as ((crc >> 15 | crc << 17) +
// 0xa282ead8) mod 2^32.  Table-driven, eight bytes a step (slicing-by-8).
uint32_t masked_crc32c(const uint8_t* data, int64_t n) {
  static uint32_t table[8][256];
  static const bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t)
        table[t][i] =
            (table[t - 1][i] >> 8) ^ table[0][table[t - 1][i] & 0xFF];
    return true;
  }();
  (void)ready;
  uint32_t crc = 0xFFFFFFFFu;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data + i, 4);        // little-endian host
    std::memcpy(&hi, data + i + 4, 4);
    lo ^= crc;
    crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
          table[5][(lo >> 16) & 0xFF] ^ table[4][lo >> 24] ^
          table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
          table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
  }
  for (; i < n; ++i) crc = table[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  crc ^= 0xFFFFFFFFu;
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // extern "C"
