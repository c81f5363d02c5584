// Shared threading helpers for the host-side native kernels
// (sortops.cpp, statops.cpp).  Header-only; build.py hashes this file
// alongside the .cpp sources so edits invalidate the cached library.
#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <functional>
#include <stdexcept>
#include <thread>
#include <vector>

namespace seekr_host {

// Threads scale with the work size so tiny inputs stay single-threaded
// (thread launch costs more than the work below per_thread_floor items).
inline int64_t pick_threads(int64_t work, int64_t per_thread_floor) {
  int64_t hw = std::max<int64_t>(1, std::thread::hardware_concurrency());
  return std::max<int64_t>(
      1, std::min(hw, work / std::max<int64_t>(1, per_thread_floor)));
}

// Exception-safe fork/join: an exception inside a worker (bad_alloc under
// memory pressure is the realistic case) is captured — never allowed to
// escape a thread entry, which would std::terminate the whole Python
// process — all threads are joined, and the failure is rethrown as ONE
// runtime_error on the calling thread, where every extern "C" entry has
// a try/catch converting it to an error return code.
inline void run_parallel(int64_t n_threads,
                         const std::function<void(int64_t)>& fn) {
  std::atomic<int> failed{0};
  auto guarded = [&](int64_t t) {
    try {
      fn(t);
    } catch (...) {
      failed.store(1, std::memory_order_relaxed);
    }
  };
  std::vector<std::thread> ts;
  try {
    ts.reserve(static_cast<size_t>(n_threads > 0 ? n_threads - 1 : 0));
    for (int64_t t = 1; t < n_threads; ++t) ts.emplace_back(guarded, t);
  } catch (...) {
    // thread spawn failed: whatever was launched still runs + joins
    failed.store(1, std::memory_order_relaxed);
  }
  guarded(0);
  for (auto& th : ts) th.join();
  if (failed.load())
    throw std::runtime_error("seekr_host worker failed (allocation?)");
}

}  // namespace seekr_host
