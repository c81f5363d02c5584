// Per-row k-mer histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel seekr_tpu/ops/count_pallas.py::count_kmers_pallas:
//   count_kmers_smem  <- _kernel            (count_pallas.py:67-122), here for 1 <= k <= 7
//   count_kmers_gmem  <- _kernel_hiblocked  (count_pallas.py:125-183) and _kernel at k = 8,
//                        here for 8 <= k <= 15
//
// Contract (the same as seekr_tpu/ops/count.py::_count_impl and the port's plain
// version seekr_tpu_torch/ops/count.py::count_torch):
//   bases   [m, lpad] int8 digits, 0..3 = A,G,T,C; any other value is invalid
//   lengths [m] int32 true sequence lengths
//   out     [m, 4^k] float32
// Window p of row r is counted when p < min(len_r, lpad) - k + 1 and none of its k
// digits is invalid.  Its code is sum_j digit[p+j] * 4^(k-1-j) (first base most
// significant: the reference's itertools.product("AGTC", k) column order).  With
// `scaled`, the integer count is multiplied by scale = 1000.0f / (float)max(nw, 1)
// when nw = len - k + 1 > 0, else by 0 -- an IEEE divide, then an IEEE multiply, as
// count_pallas.py:116-120 does, so the result is bitwise equal to the plain version.
// Build without --use_fast_math: it turns the divide into an approximate one.
//
// The TPU kernel's one-hot GEMM form exists because the TPU has no fast scatter
// (docs/DESIGN.md section 2).  Hopper has fast shared-memory atomics, so the natural
// form is a histogram in shared memory:
//   * count_kmers_smem: one block per row, a dynamic-shared int32 histogram of 4^k
//     bins (16 KB at k = 6, 64 KB at k = 7).  Threads stride over window starts and
//     atomicAdd; after a barrier the block writes the scaled row, coalesced.
//   * count_kmers_gmem: 4^8 int32 bins are 256 KB, over the 227 KB a block may use, so
//     for k >= 8 the same walk atomicAdds into global memory (several blocks per row),
//     into the output buffer itself, zeroed by the caller and read as int32; a second
//     kernel converts each bin in place to its scaled float32 value.
//
// What bounds it: the work is integer and has no floating-point products, so the
// floor is memory traffic -- one read of the digits and one float32 write of m * 4^k.
// At m = 13,000, lpad = 4,096, k = 6 that is 53 MB + 213 MB, about 80 us at
// 3.35 TB/s.  This first version is simple on purpose: per-row zeroing, contention on
// shared atomics and k byte loads per window keep it away from that floor.  Staging
// rows with cp.async/TMA, warp-private sub-histograms and persistent blocks are
// left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float row_scale(int len, int k) {
  const int nw = len - (k - 1);
  return nw > 0 ? 1000.0f / (float)max(nw, 1) : 0.0f;
}

// Window code of the k digits at `p`, or -1 when one of them is invalid.
__device__ __forceinline__ int window_code(const int8_t* row, int64_t p, int k) {
  unsigned int code = 0;
  bool bad = false;
  for (int j = 0; j < k; ++j) {
    const unsigned int d = (unsigned char)row[p + j];
    bad |= d >= 4u;
    code = code * 4u + (d & 3u);
  }
  return bad ? -1 : (int)code;
}

__device__ __forceinline__ int64_t row_windows(int len, int64_t lpad, int k) {
  // windows that start before len - k + 1 and lie inside the padded row
  const int64_t n = ((int64_t)len < lpad ? (int64_t)len : lpad) - (k - 1);
  return n > 0 ? n : 0;
}

__global__ void __launch_bounds__(kThreads)
count_smem_kernel(const int8_t* __restrict__ bases, const int* __restrict__ lengths,
                  float* __restrict__ out, int64_t lpad, int k, int scaled) {
  extern __shared__ int hist[];
  const int64_t r = blockIdx.x;
  const int n_bins = 1 << (2 * k);
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int len = lengths[r];
  const int64_t nw = row_windows(len, lpad, k);
  const int8_t* row = bases + r * lpad;
  for (int64_t p = threadIdx.x; p < nw; p += blockDim.x) {
    const int code = window_code(row, p, k);
    if (code >= 0) atomicAdd(&hist[code], 1);
  }
  __syncthreads();

  float* dst = out + r * (int64_t)n_bins;
  if (scaled) {
    const float scale = row_scale(len, k);
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) dst[i] = (float)hist[i] * scale;
  } else {
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) dst[i] = (float)hist[i];
  }
}

__global__ void __launch_bounds__(kThreads)
count_gmem_kernel(const int8_t* __restrict__ bases, const int* __restrict__ lengths,
                  int* __restrict__ hist, int64_t lpad, int k) {
  const int64_t r = blockIdx.x;
  const int64_t nw = row_windows(lengths[r], lpad, k);
  const int8_t* row = bases + r * lpad;
  int* dst = hist + r * ((int64_t)1 << (2 * k));
  const int64_t stride = (int64_t)gridDim.y * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; p < nw; p += stride) {
    const int code = window_code(row, p, k);
    if (code >= 0) atomicAdd(&dst[code], 1);
  }
}

// In place: each int32 bin becomes its float32 value (raw or scaled).
__global__ void __launch_bounds__(kThreads)
scale_gmem_kernel(int* __restrict__ buf, const int* __restrict__ lengths, int64_t m,
                  int k, int scaled) {
  const int shift = 2 * k;
  const int64_t total = m << shift;
  float* out = reinterpret_cast<float*>(buf);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float c = (float)buf[i];
    out[i] = scaled ? c * row_scale(lengths[i >> shift], k) : c;
  }
}

}  // namespace

extern "C" {

const char* seekr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shared-memory histogram, 1 <= k <= 7.  Returns a cudaError_t (0 = launched).
int seekr_count_kmers_smem(const void* bases, const void* lengths, void* out, int64_t m,
                           int64_t lpad, int k, int scaled, int device, void* stream) {
  if (k < 1 || k > 7 || m < 1 || m > 0x7fffffff || lpad < k) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)(sizeof(int) << (2 * k));
  err = cudaFuncSetAttribute(count_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  count_smem_kernel<<<(unsigned int)m, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)bases, (const int*)lengths, (float*)out, lpad, k, scaled);
  return (int)cudaGetLastError();
}

// Global-memory histogram, 8 <= k <= 15.  `out` must hold m * 4^k zeroed 32-bit
// words; it is filled with int32 counts, then converted in place to float32.
int seekr_count_kmers_gmem(const void* bases, const void* lengths, void* out, int64_t m,
                           int64_t lpad, int k, int scaled, int device, void* stream) {
  if (k < 8 || k > 15 || m < 1 || m > 0x7fffffff || lpad < k) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // about 8 windows per thread, at most 64 blocks per row
  const int64_t w = lpad - k + 1;
  int64_t per_row = (w + kThreads * 8 - 1) / (kThreads * 8);
  per_row = per_row < 1 ? 1 : (per_row > 64 ? 64 : per_row);
  dim3 grid((unsigned int)m, (unsigned int)per_row);
  count_gmem_kernel<<<grid, kThreads, 0, s>>>((const int8_t*)bases, (const int*)lengths,
                                             (int*)out, lpad, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = m << (2 * k);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  scale_gmem_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>((int*)out, (const int*)lengths,
                                                              m, k, scaled);
  return (int)cudaGetLastError();
}

}  // extern "C"
