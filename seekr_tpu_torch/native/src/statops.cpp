// Multithreaded helpers for the symmetric p-value-matrix path of
// adj_pval (stats/adj_pval.py, mirroring seekr/adj_pval.py:53-59 and the
// triu subset at seekr/adj_pval.py:74-90).  At GENCODE scale the matrix
// is 13k x 13k (169M float64 cells): the numpy route pays a full-matrix
// np.round copy for the symmetry test and first-touch page faults on
// every fresh triangle buffer, which together dwarf the correction
// itself once that is native too (sortops.cpp).
//
// Rounding matches np.round(x, 5) exactly: multiply by 1e5, rint under
// the default round-half-even mode, divide by 1e5 — the same three IEEE
// ops numpy emits for positive-decimal rounding of float64.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

#include "host_parallel.h"

namespace {

using seekr_host::pick_threads;
using seekr_host::run_parallel;

inline double round5(double v) {
  return std::rint(v * 100000.0) / 100000.0;
}

}  // namespace

extern "C" {

// 5-decimal-rounded transpose equality (NaN == NaN), the symmetric-input
// test of adj_pval.  Tiled so each mirror pair of blocks stays cache
// resident; early-exits on the first asymmetric tile.
// Returns 1 (symmetric), 0 (not), -1 (bad args).
int64_t seekr_sym_round5_f64(const double* mat, int64_t m) {
  if (m < 0 || (m > 0 && !mat)) return -1;
  if (m <= 1) return 1;
  try {
  constexpr int64_t kTile = 256;
  const int64_t n_tiles = (m + kTile - 1) / kTile;
  // upper-triangle tile pairs, flattened for round-robin assignment
  std::vector<std::pair<int64_t, int64_t>> pairs;
  for (int64_t ti = 0; ti < n_tiles; ++ti)
    for (int64_t tj = ti; tj < n_tiles; ++tj) pairs.emplace_back(ti, tj);
  const int64_t n_threads =
      pick_threads(static_cast<int64_t>(pairs.size()), 1);
  std::atomic<int> asym{0};
  run_parallel(n_threads, [&](int64_t t) {
    for (size_t p = static_cast<size_t>(t); p < pairs.size();
         p += static_cast<size_t>(n_threads)) {
      if (asym.load(std::memory_order_relaxed)) return;
      const int64_t i0 = pairs[p].first * kTile;
      const int64_t j0 = pairs[p].second * kTile;
      const int64_t i1 = std::min(m, i0 + kTile);
      const int64_t j1 = std::min(m, j0 + kTile);
      for (int64_t i = i0; i < i1; ++i)
        for (int64_t j = j0; j < j1; ++j) {
          const double a = round5(mat[i * m + j]);
          const double b = round5(mat[j * m + i]);
          if (a == b || (std::isnan(a) && std::isnan(b))) continue;
          asym.store(1, std::memory_order_relaxed);
          return;
        }
    }
  });
  return asym.load() ? 0 : 1;
  } catch (...) {
    return -4;  // exceptions must not cross the C ABI
  }
}

// Strict-upper-triangle (k=1) values in row-major order — the
// mat[np.triu_indices(m, 1)] gather, parallel over row bands.
int64_t seekr_triu_values_f64(const double* mat, int64_t m, double* out) {
  if (m < 0 || (m > 0 && (!mat || !out))) return -1;
  if (m <= 1) return 0;
  try {
  const int64_t n_threads = pick_threads(m * m, 1 << 20);
  run_parallel(n_threads, [&](int64_t t) {
    for (int64_t i = t; i < m - 1; i += n_threads) {
      // row i starts at position i*m - i(i+1)/2 of the triangle vector
      const int64_t pos = i * m - i * (i + 1) / 2;
      const int64_t cnt = m - i - 1;
      std::copy_n(mat + i * m + i + 1, cnt, out + pos);
    }
  });
  return 0;
  } catch (...) {
    return -4;
  }
}

// Inverse of the gather: out[i, j] = flat[tri(i, j)] for j > i, else
// fill.  Parallel over row bands; writes every cell exactly once, so the
// big output buffer is touched in a single multithreaded pass instead of
// numpy's np.full + per-row rewrite.
int64_t seekr_triu_fill_f64(const double* flat, int64_t m, double fill,
                            double* out) {
  if (m < 0 || (m > 0 && !out) || (m > 1 && !flat)) return -1;
  try {
  const int64_t n_threads = pick_threads(m * m, 1 << 20);
  run_parallel(n_threads, [&](int64_t t) {
    for (int64_t i = t; i < m; i += n_threads) {
      double* row = out + i * m;
      std::fill(row, row + std::min(i + 1, m), fill);
      if (i < m - 1) {
        const int64_t pos = i * m - i * (i + 1) / 2;
        std::copy_n(flat + pos, m - i - 1, row + i + 1);
      }
    }
  });
  return 0;
  } catch (...) {
    return -4;
  }
}

}  // extern "C"
