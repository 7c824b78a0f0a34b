// Native data-path kernels: threaded .npy batch reading and padded collate.
//
// The port's own copy of morgana_tpu/data/csrc/batch_io.cpp: the hot
// host-side copies of the data path, a small dependency-free C++ library
// driven from the Python loader (morgana_tpu_torch/data/native_io.py) via
// ctypes:
//
//   * npy_batch_shapes: parse .npy headers (v1/v2, '<f4', C-order) for a
//     batch of files, returning (rows, cols) per file.
//   * npy_batch_fill:   read all files in parallel threads straight into a
//     caller-allocated zero-padded (batch, max_len, feat_dim) buffer —
//     no per-file Python object churn, GIL fully released.
//   * pad_collate_f32:  zero-pad a batch of in-memory float32 sequences into
//     a (batch, max_len, feat_dim) buffer in parallel.
//
// Built on first use by morgana_tpu_torch/_build.py::build_cxx (g++ -O3
// -march=native -shared -fPIC -std=c++17 -pthread) into the build directory.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long long rows = -1;
  long long cols = -1;
  long long data_offset = 0;
};

// Parses a .npy header. Returns false on unsupported files.
bool ParseNpyHeader(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  // header_len comes from the FILE: a corrupt/truncated .npy could name a
  // ~4 GB header whose allocation throws bad_alloc inside a worker thread
  // (std::terminate). Real numpy headers are < 64 KiB even for huge shapes.
  if (header_len == 0 || header_len > (1u << 20)) return false;
  std::string header(header_len, '\0');
  if (fread(header.data(), 1, header_len, f) != header_len) return false;

  if (header.find("'descr': '<f4'") == std::string::npos &&
      header.find("\"descr\": \"<f4\"") == std::string::npos)
    return false;
  if (header.find("'fortran_order': False") == std::string::npos &&
      header.find("\"fortran_order\": false") == std::string::npos)
    return false;

  auto pos = header.find("'shape':");
  if (pos == std::string::npos) pos = header.find("\"shape\":");
  if (pos == std::string::npos) return false;
  auto open = header.find('(', pos);
  auto close = header.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string shape = header.substr(open + 1, close - open - 1);

  long long dims[2] = {1, 1};
  int ndim = 0;
  const char* p = shape.c_str();
  while (*p) {
    while (*p == ' ' || *p == ',') ++p;
    if (*p < '0' || *p > '9') break;
    if (ndim >= 2) return false;  // >2-d: refuse rather than misread
    dims[ndim++] = strtoll(p, const_cast<char**>(&p), 10);
  }
  if (ndim == 0) return false;
  info->rows = dims[0];
  info->cols = (ndim >= 2) ? dims[1] : 1;
  return true;
}

int NumThreads(long long n) {
  unsigned hw = std::thread::hardware_concurrency();
  long long t = hw ? hw : 4;
  if (t > n) t = n;
  if (t > 16) t = 16;
  return (int)(t > 0 ? t : 1);
}

}  // namespace

extern "C" {

// ABI version of this library's entry points; the ctypes loader refuses a
// library whose version does not match (stale .so protection).
long long morgana_batch_io_abi() { return 1; }

// Fills rows/cols per file. Returns 0 on success, -(index+1) of first bad file.
long long npy_batch_shapes(const char** paths, long long n,
                           long long* rows, long long* cols) {
  std::atomic<long long> status{0};
  int num_threads = NumThreads(n);
  std::vector<std::thread> ts;
  for (int tid = 0; tid < num_threads; ++tid) {
    ts.emplace_back([&, tid]() {
      for (long long i = tid; i < n; i += num_threads) {
        FILE* f = fopen(paths[i], "rb");
        NpyInfo info;
        bool ok = f && ParseNpyHeader(f, &info);
        if (f) fclose(f);
        if (!ok) {
          long long mine = -(i + 1), cur = status.load();
          while ((cur == 0 || mine > cur) &&
                 !status.compare_exchange_weak(cur, mine)) {}
          rows[i] = -1;
          cols[i] = -1;
        } else {
          rows[i] = info.rows;
          cols[i] = info.cols;
        }
      }
    });
  }
  for (auto& t : ts) t.join();
  return status;
}

// Reads n float32 .npy files into out (n, max_len, feat_dim), zero padded.
// Rows beyond max_len are truncated; files whose cols != feat_dim fail.
// Returns 0 on success, -(index+1) of first bad file.
long long npy_batch_fill(const char** paths, long long n, float* out,
                         long long max_len, long long feat_dim) {
  std::atomic<long long> status{0};
  int num_threads = NumThreads(n);
  std::vector<std::thread> ts;
  for (int tid = 0; tid < num_threads; ++tid) {
    ts.emplace_back([&, tid]() {
      for (long long i = tid; i < n; i += num_threads) {
        float* dst = out + i * max_len * feat_dim;
        memset(dst, 0, sizeof(float) * max_len * feat_dim);
        FILE* f = fopen(paths[i], "rb");
        NpyInfo info;
        bool ok = f && ParseNpyHeader(f, &info) && info.cols == feat_dim;
        if (ok) {
          long long rows = info.rows < max_len ? info.rows : max_len;
          fseek(f, (long)info.data_offset, SEEK_SET);
          ok = fread(dst, sizeof(float), rows * feat_dim, f) ==
               (size_t)(rows * feat_dim);
        }
        if (f) fclose(f);
        if (!ok) {
          long long mine = -(i + 1), cur = status.load();
          while ((cur == 0 || mine > cur) &&
                 !status.compare_exchange_weak(cur, mine)) {}
        }
      }
    });
  }
  for (auto& t : ts) t.join();
  return status;
}

// Pads a batch of in-memory float32 (len_i, feat_dim) arrays into
// out (n, max_len, feat_dim), zero-filled beyond each length.
long long pad_collate_f32(const float** srcs, const long long* lens,
                          long long n, long long feat_dim, long long max_len,
                          float* out) {
  int num_threads = NumThreads(n);
  std::vector<std::thread> ts;
  for (int tid = 0; tid < num_threads; ++tid) {
    ts.emplace_back([&, tid]() {
      for (long long i = tid; i < n; i += num_threads) {
        float* dst = out + i * max_len * feat_dim;
        long long rows = lens[i] < max_len ? lens[i] : max_len;
        memcpy(dst, srcs[i], sizeof(float) * rows * feat_dim);
        memset(dst + rows * feat_dim, 0,
               sizeof(float) * (max_len - rows) * feat_dim);
      }
    });
  }
  for (auto& t : ts) t.join();
  return 0;
}

}  // extern "C"
