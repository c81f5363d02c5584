// Multithreaded stable argsort, permutation scatter, and a fully fused
// FDR (Benjamini-Hochberg / Benjamini-Yekutieli) correction for the host
// stats chain.  seekr_tpu-native replacement for the np.argsort /
// fancy-index / elementwise hot path inside stats/multitest.py (the
// statsmodels-equivalent of the reference's adj_pval call sites,
// seekr/adj_pval.py:81,100,119): at GENCODE scale the corrected-p
// pipeline sorts ~84.5M float64 p-values, and single-threaded introsort,
// two random-access fancy-index passes, and page-faulting elementwise
// temporaries dominate its wall time.
//
// Sort design: LSD radix over order-preserving u64 key transforms, 8-bit
// digits (256 open write streams per scatter stay TLB/cache resident — a
// 16-bit radix measured ~1.3x slower end-to-end at 84.5M — and the small
// bucket count lets each scatter pass fuse the NEXT pass's per-block
// histogram for free), constant digits skipped, contiguous per-thread
// blocks with a (digit, thread) offset table so the scatter is stable by
// construction — ties keep their original relative order, i.e.
// np.argsort(kind="stable") semantics.  Items carry (key, index) so the
// sorted values come out of the final pass via the inverse key transform
// instead of a random gather.
//
// NaN keys (either sign) collapse to the maximal key, so — like numpy —
// they land at the end in first-appearance order.  (The Python wrapper
// falls back to numpy when NaNs are present anyway, because the collapse
// canonicalises NaN payloads in the sorted-values output, and the fused
// FDR entry reports NaNs via its return code for the same reason.)
//
// One documented divergence from np.argsort(kind="stable"): numpy's
// comparison sort ties -0.0 with +0.0 (first appearance wins), while the
// radix key orders -0.0 strictly before +0.0.  Both orders are valid
// stable sorts of ==-equal elements; the sorted values and every
// downstream corrected p-value compare equal either way.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

#include "host_parallel.h"

namespace {

using seekr_host::pick_threads;
using seekr_host::run_parallel;

struct Item {
  uint64_t key;
  uint64_t idx;
};

inline uint64_t key_transform(double v) {
  uint64_t bits;
  std::memcpy(&bits, &v, sizeof(bits));
  if (std::isnan(v)) return ~0ull;  // all NaNs sort together, at the top
  // order-preserving map: positives flip the sign bit, negatives flip all
  return (bits & 0x8000000000000000ull) ? ~bits
                                        : bits ^ 0x8000000000000000ull;
}

inline double key_untransform(uint64_t key) {
  uint64_t bits = (key & 0x8000000000000000ull)
                      ? key ^ 0x8000000000000000ull
                      : ~key;
  double v;
  std::memcpy(&v, &bits, sizeof(v));
  return v;
}

constexpr int kDigitBits = 8;
constexpr int64_t kRadix = int64_t{1} << kDigitBits;
constexpr int kPasses = 8;

// Stable radix sort of (transformed key, original index) items.  Fills
// a/b, returns the buffer holding the sorted items.  When fail_on_nan is
// set and a NaN key is seen, returns nullptr (buffers undefined).
Item* sort_items(const double* keys, int64_t n, int64_t n_threads,
                 int64_t block, std::vector<Item>& a, std::vector<Item>& b,
                 bool fail_on_nan) {
  a.resize(static_cast<size_t>(n));
  b.resize(static_cast<size_t>(n));

  // One build sweep: items + per-block digit histograms for every pass.
  // Global counts (their thread-sums) are permutation-invariant and drive
  // pass skipping; the PER-BLOCK counts are only valid for the initial
  // layout, so just the first executed pass consumes them — each scatter
  // then emits the following pass's per-block histogram as it runs.
  std::vector<std::vector<uint64_t>> bhist(
      static_cast<size_t>(n_threads),
      std::vector<uint64_t>(kPasses * kRadix, 0));
  std::atomic<int> saw_nan{0};
  run_parallel(n_threads, [&](int64_t t) {
    const int64_t lo = t * block, hi = std::min(n, lo + block);
    uint64_t* h = bhist[static_cast<size_t>(t)].data();
    for (int64_t i = lo; i < hi; ++i) {
      const double v = keys[i];
      if (fail_on_nan && std::isnan(v)) {
        saw_nan.store(1, std::memory_order_relaxed);
        return;
      }
      uint64_t key = key_transform(v);
      a[static_cast<size_t>(i)] = {key, static_cast<uint64_t>(i)};
      for (int p = 0; p < kPasses; ++p)
        ++h[p * kRadix + ((key >> (p * kDigitBits)) & (kRadix - 1))];
    }
  });
  if (saw_nan.load()) return nullptr;

  // executed-pass chain from the global (thread-summed) counts
  int executed[kPasses];
  int n_exec = 0;
  for (int pass = 0; pass < kPasses; ++pass) {
    for (int64_t d = 0; d < kRadix; ++d) {
      uint64_t c = 0;
      for (int64_t t = 0; t < n_threads; ++t)
        c += bhist[static_cast<size_t>(t)][pass * kRadix + d];
      if (c) {
        if (c != static_cast<uint64_t>(n)) executed[n_exec++] = pass;
        break;
      }
    }
  }

  Item* src = a.data();
  Item* dst = b.data();
  // hist[t][d]: current-layout per-block histogram of the pass being run
  std::vector<std::vector<uint64_t>> hist(
      static_cast<size_t>(n_threads), std::vector<uint64_t>(kRadix, 0));
  for (int64_t t = 0; t < n_threads; ++t)
    if (n_exec > 0)
      std::copy_n(
          bhist[static_cast<size_t>(t)].data() + executed[0] * kRadix,
          kRadix, hist[static_cast<size_t>(t)].data());
  bhist.clear();
  bhist.shrink_to_fit();

  std::vector<uint64_t> offsets(static_cast<size_t>(n_threads * kRadix));
  // nexthist[src_thread][dest_block * kRadix + digit] — accumulated during
  // the scatter, summed over src_threads afterwards
  std::vector<std::vector<uint64_t>> nexthist(
      static_cast<size_t>(n_threads),
      std::vector<uint64_t>(n_threads * kRadix, 0));
  for (int ei = 0; ei < n_exec; ++ei) {
    const int shift = executed[ei] * kDigitBits;
    const int next_shift =
        (ei + 1 < n_exec) ? executed[ei + 1] * kDigitBits : -1;

    // exclusive scan in (digit, thread) order => stable scatter targets
    uint64_t run = 0;
    for (int64_t d = 0; d < kRadix; ++d)
      for (int64_t t = 0; t < n_threads; ++t) {
        offsets[static_cast<size_t>(t * kRadix + d)] = run;
        run += hist[static_cast<size_t>(t)][d];
      }

    run_parallel(n_threads, [&](int64_t t) {
      const int64_t lo = t * block, hi = std::min(n, lo + block);
      uint64_t* off = offsets.data() + t * kRadix;
      uint64_t* nh = nexthist[static_cast<size_t>(t)].data();
      if (next_shift >= 0) {
        std::fill(nh, nh + n_threads * kRadix, 0);
        for (int64_t i = lo; i < hi; ++i) {
          const Item it = src[i];
          const uint64_t j = off[(it.key >> shift) & (kRadix - 1)]++;
          dst[j] = it;
          ++nh[static_cast<int64_t>(j) / block * kRadix +
               ((it.key >> next_shift) & (kRadix - 1))];
        }
      } else {
        for (int64_t i = lo; i < hi; ++i) {
          const Item it = src[i];
          dst[off[(it.key >> shift) & (kRadix - 1)]++] = it;
        }
      }
    });
    std::swap(src, dst);

    if (next_shift >= 0) {
      for (int64_t t = 0; t < n_threads; ++t) {
        uint64_t* h = hist[static_cast<size_t>(t)].data();
        std::fill(h, h + kRadix, 0);
        for (int64_t s = 0; s < n_threads; ++s) {
          const uint64_t* nh =
              nexthist[static_cast<size_t>(s)].data() + t * kRadix;
          for (int64_t d = 0; d < kRadix; ++d) h[d] += nh[d];
        }
      }
    }
  }
  return src;
}

// numpy-exact elementwise pieces of the BH/BY correction, shared by the
// sorted-domain and fused entries.  ecdf is (i+1)/n, divided by the
// harmonic sum for BY — the SAME operation order as multitest.py's numpy
// path so results are bitwise identical.
inline double bh_ecdf(int64_t i, int64_t n, double harmonic_sum) {
  double e = static_cast<double>(i + 1) / static_cast<double>(n);
  if (harmonic_sum > 0.0) e /= harmonic_sum;
  return e;
}

// np.clip(x, 0, 1) == minimum(maximum(x, 0), 1); ties return the second
// argument, so -0.0 canonicalises to +0.0 exactly like numpy.
inline double clip01(double x) {
  x = (x > 0.0) ? x : 0.0;
  return (x < 1.0) ? x : 1.0;
}

// Computes clip01(suffix-min of p_sorted[i]/ecdf[i]) into corrected_out
// and returns the BH rejection count (leading sorted hypotheses with
// p <= ecdf*alpha).  p(i) abstracts the storage (raw array or sorted
// items) so both public entries share the pass structure; it is a
// template parameter so the per-element access inlines into the three
// hot passes (std::function dispatch per element defeated
// vectorization of exactly the loops this file exists to accelerate).
template <typename P>
int64_t fdr_from_sorted(const P& p, int64_t n,
                        double alpha, double harmonic_sum,
                        int64_t n_threads, int64_t block,
                        double* corrected_out) {
  // phase A: per-block raw minima of c_i = p_i/e_i (unclipped), and the
  // per-block last index with p_i <= e_i*alpha
  std::vector<double> block_min(static_cast<size_t>(n_threads));
  std::vector<int64_t> block_last(static_cast<size_t>(n_threads));
  run_parallel(n_threads, [&](int64_t t) {
    const int64_t lo = t * block, hi = std::min(n, lo + block);
    double bm = std::numeric_limits<double>::infinity();
    int64_t last = -1;
    for (int64_t i = lo; i < hi; ++i) {
      const double e = bh_ecdf(i, n, harmonic_sum);
      const double pi = p(i);
      const double c = pi / e;
      // np.minimum(acc, x): ties keep the SECOND operand
      bm = (bm < c) ? bm : c;
      if (pi <= e * alpha) last = i;
    }
    block_min[static_cast<size_t>(t)] = bm;
    block_last[static_cast<size_t>(t)] = last;
  });

  // phase B: suffix combine across blocks (later blocks feed earlier ones)
  std::vector<double> suffix(static_cast<size_t>(n_threads),
                             std::numeric_limits<double>::infinity());
  for (int64_t t = n_threads - 2; t >= 0; --t) {
    const double later = suffix[static_cast<size_t>(t + 1)];
    const double bm = block_min[static_cast<size_t>(t + 1)];
    suffix[static_cast<size_t>(t)] = (later < bm) ? later : bm;
  }
  int64_t last_reject = -1;
  for (int64_t t = n_threads - 1; t >= 0; --t)
    if (block_last[static_cast<size_t>(t)] >= 0) {
      last_reject = block_last[static_cast<size_t>(t)];
      break;
    }

  // phase C: backward walk per block with the numpy accumulate tie rule
  run_parallel(n_threads, [&](int64_t t) {
    const int64_t lo = t * block, hi = std::min(n, lo + block);
    double run = suffix[static_cast<size_t>(t)];
    for (int64_t i = hi - 1; i >= lo; --i) {
      const double c = p(i) / bh_ecdf(i, n, harmonic_sum);
      run = (run < c) ? run : c;
      corrected_out[i] = clip01(run);
    }
  });
  return last_reject + 1;
}

}  // namespace

extern "C" {

// Stable ascending argsort of float64 keys.  Writes the permutation into
// order[n] (int64) and the sorted values into sorted_out[n].
// Returns 0 on success, -1 on invalid arguments, -4 on an internal
// failure (allocation at the ~2.7 GB 84.5M-element scale): exceptions
// must not cross the C ABI — the Python wrapper raises and the caller
// falls back to numpy.
int64_t seekr_argsort_f64(const double* keys, int64_t n, int64_t* order,
                          double* sorted_out) {
  if (n < 0 || (n > 0 && (!keys || !order || !sorted_out))) return -1;
  if (n == 0) return 0;
  try {
  const int64_t n_threads = pick_threads(n, 1 << 15);
  const int64_t block = (n + n_threads - 1) / n_threads;
  std::vector<Item> a, b;
  Item* src = sort_items(keys, n, n_threads, block, a, b, false);
  run_parallel(n_threads, [&](int64_t t) {
    const int64_t lo = t * block, hi = std::min(n, lo + block);
    for (int64_t i = lo; i < hi; ++i) {
      order[i] = static_cast<int64_t>(src[i].idx);
      sorted_out[i] = key_untransform(src[i].key);
    }
  });
  return 0;
  } catch (...) {
    return -4;
  }
}

// Inverse-permutation scatter: out_vals[order[i]] = vals[i], and (when the
// flag pointers are non-null) out_flags[order[i]] = flags[i].  This is the
// pair of fancy-index assignments at the tail of multipletests fused into
// one pass over the permutation.  PRECONDITION: order is a permutation —
// out-of-range indices return -2, but duplicates are not detected and
// would race the same output slot across threads (numpy fancy indexing
// is deterministic last-write-wins; this is not).
int64_t seekr_scatter_f64_u8(const double* vals, const uint8_t* flags,
                             const int64_t* order, int64_t n,
                             double* out_vals, uint8_t* out_flags) {
  if (n < 0 || (n > 0 && (!vals || !order || !out_vals))) return -1;
  if ((flags == nullptr) != (out_flags == nullptr)) return -1;
  try {
  const int64_t n_threads = pick_threads(n, 1 << 16);
  const int64_t block = (n + n_threads - 1) / n_threads;
  std::atomic<int64_t> bad{0};
  run_parallel(n_threads, [&](int64_t t) {
    const int64_t lo = t * block, hi = std::min(n, lo + block);
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t j = order[i];
      if (j < 0 || j >= n) {
        bad.store(1, std::memory_order_relaxed);
        return;
      }
      out_vals[j] = vals[i];
      if (flags) out_flags[j] = flags[i];
    }
  });
  return bad.load() ? -2 : 0;
  } catch (...) {
    return -4;
  }
}

// BH/BY correction of an ALREADY ASCENDING-SORTED p-value vector
// (multitest._fdr_correct's inner math, bitwise identical): writes the
// clipped suffix-min corrected values and returns the rejection count
// (>=0), i.e. how many leading sorted hypotheses have p <= ecdf*alpha.
// harmonic_sum <= 0 selects plain BH; pass sum(1/i) for BY.
// Returns -1 on invalid arguments.
int64_t seekr_fdr_sorted_f64(const double* p_sorted, int64_t n, double alpha,
                             double harmonic_sum, double* corrected_out) {
  if (n < 0 || (n > 0 && (!p_sorted || !corrected_out))) return -1;
  if (n == 0) return 0;
  try {
    const int64_t n_threads = pick_threads(n, 1 << 16);
    const int64_t block = (n + n_threads - 1) / n_threads;
    return fdr_from_sorted([p_sorted](int64_t i) { return p_sorted[i]; }, n,
                           alpha, harmonic_sum, n_threads, block,
                           corrected_out);
  } catch (...) {
    return -4;
  }
}

// Fully fused BH/BY correction of an UNSORTED p-value vector: stable
// radix argsort, suffix-min correction, and the unsort scatter of both
// outputs in one call with no Python-side temporaries.  Writes corrected
// p-values (original order) into corrected_out and the reject mask into
// reject_out.  Returns the rejection count (>=0), -1 on invalid
// arguments, or -3 when a NaN p-value is present (caller falls back to
// the numpy path, which propagates NaN through the accumulate exactly as
// statsmodels would).
int64_t seekr_fdr_f64(const double* pvals, int64_t n, double alpha,
                      double harmonic_sum, double* corrected_out,
                      uint8_t* reject_out) {
  if (n < 0 || (n > 0 && (!pvals || !corrected_out || !reject_out)))
    return -1;
  if (n == 0) return 0;
  try {
  const int64_t n_threads = pick_threads(n, 1 << 15);
  const int64_t block = (n + n_threads - 1) / n_threads;
  std::vector<Item> a, b;
  Item* src = sort_items(pvals, n, n_threads, block, a, b, true);
  if (src == nullptr) return -3;

  std::vector<double> corrected_sorted(static_cast<size_t>(n));
  const int64_t n_reject = fdr_from_sorted(
      [src](int64_t i) { return key_untransform(src[i].key); }, n, alpha,
      harmonic_sum, n_threads, block, corrected_sorted.data());

  run_parallel(n_threads, [&](int64_t t) {
    const int64_t lo = t * block, hi = std::min(n, lo + block);
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t j = static_cast<int64_t>(src[i].idx);
      corrected_out[j] = corrected_sorted[static_cast<size_t>(i)];
      reject_out[j] = i < n_reject;
    }
  });
  return n_reject;
  } catch (...) {
    return -4;
  }
}

}  // extern "C"
