// Per-row k-mer histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel seekr_tpu/ops/count_pallas.py::count_kmers_pallas:
//   count_kmers_smem       <- _kernel            (count_pallas.py:67-122), here for 1 <= k <= 7
//   count_kmers_hiblocked  <- _kernel_hiblocked  (count_pallas.py:125-183) and _kernel at
//                             k = 8, here for 8 <= k <= 15
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
// What bounds both kernels: the work is integer, with no floating-point products,
// so the floor is memory traffic -- one read of the digits and one float32 write of
// m * 4^k.  The TPU kernel's one-hot GEMM form exists because the TPU has no fast
// scatter (docs/DESIGN.md section 2); Hopper has fast shared-memory atomics, so the
// natural form is a histogram in shared memory.
//
// * count_kmers_smem: one block per row, a dynamic-shared int32 histogram of 4^k bins
//   (16 KB at k = 6, 64 KB at k = 7).  Threads stride over window starts and
//   atomicAdd; after a barrier the block writes the scaled row, coalesced.
//
// * count_kmers_hiblocked: at k >= 8 a row's 4^k bins (1 MB of float32 at k = 9) do
//   not fit a block, and almost all of them are zero, so the output write is the
//   whole cost.  As _kernel_hiblocked tiles its bins into hi-blocks and re-derives
//   the window codes for each, this kernel cuts a row into slices of S contiguous
//   bins (the launcher's hiblock_plan: 2^14 int32 bins, 64 KB of shared memory).  A
//   tile is one (row, slice): the block walks all of the row's windows, counts in
//   shared memory only those whose code >> log2(S) is its slice, and after a barrier
//   writes the slice once, as scaled float32, with 16-byte streaming stores.  So
//   every output byte crosses device memory once: no zero pass, no global atomics,
//   no second conversion pass.  The walk is cheap: a thread takes a contiguous run
//   of window starts and keeps a rolling code, reading each digit once; a row's
//   slices are consecutive tiles, so its digits come from device memory once and
//   from L2 after that (<= 16 KB of L2 reads per 64 KB written at k = 9).  The grid
//   is persistent (SMs x resident blocks, worked out with the shared-memory
//   attributes once per device) and loops over 64-bit tile indices, which pass 2^31
//   at k = 15; the write of a slice clears its shared bins for the next tile.
//
// What keeps count_kmers_smem from its floor: per-row zeroing, contention on shared
// atomics and k byte loads per window.  It reaches about half of its bound and is
// left as it is.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHiThreads = 512;
constexpr int kHiMinBlocks = 3;  // 3 x 64 KB of shared memory on one SM

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

__global__ void __launch_bounds__(kHiThreads, kHiMinBlocks)
count_hiblocked_kernel(const int8_t* __restrict__ bases, const int* __restrict__ lengths,
                       float* __restrict__ out, int64_t m, int64_t lpad, int k,
                       int slice_log2, int scaled) {
  extern __shared__ uint4 smem[];
  unsigned int* bins = reinterpret_cast<unsigned int*>(smem);
  const int slice_bins = 1 << slice_log2;
  const int slices_log2 = 2 * k - slice_log2;
  const unsigned int code_mask = (1u << (2 * k)) - 1u;
  const int64_t n_tiles = m << slices_log2;

  for (int i = threadIdx.x; i < slice_bins; i += blockDim.x) bins[i] = 0u;
  __syncthreads();

  // slice index fastest: a row's tiles run together, its digits stay in L2
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t >> slices_log2;
    const unsigned int slice = (unsigned int)(t & ((1 << slices_log2) - 1));
    const int len = lengths[r];
    const int64_t nw = row_windows(len, lpad, k);
    const int8_t* row = bases + r * lpad;

    // a contiguous run of window starts per thread, with a rolling code and the
    // number of valid digits since the last invalid one
    const int64_t run = (nw + blockDim.x - 1) / blockDim.x;
    int64_t p = (int64_t)threadIdx.x * run;
    const int64_t end = p + run < nw ? p + run : nw;
    if (p < end) {
      unsigned int code = 0u;
      int valid = 0;
      for (int j = 0; j < k - 1; ++j) {
        const unsigned int d = (unsigned char)__ldg(row + p + j);
        code = (code << 2) | (d & 3u);
        valid = d < 4u ? valid + 1 : 0;
      }
      for (; p < end; ++p) {
        const unsigned int d = (unsigned char)__ldg(row + p + k - 1);
        code = ((code << 2) | (d & 3u)) & code_mask;
        valid = d < 4u ? valid + 1 : 0;
        if (valid >= k && (code >> slice_log2) == slice) {
          atomicAdd(&bins[code & (unsigned int)(slice_bins - 1)], 1u);
        }
      }
    }
    __syncthreads();

    // raw counts times 1.0f are exact, so one expression serves both modes; the
    // read of four bins clears them for the next tile
    const float scale = scaled ? row_scale(len, k) : 1.0f;
    float4* dst = reinterpret_cast<float4*>(out + (r << (2 * k)) +
                                            ((int64_t)slice << slice_log2));
    for (int v = threadIdx.x; v < slice_bins / 4; v += blockDim.x) {
      const uint4 c = smem[v];
      smem[v] = make_uint4(0u, 0u, 0u, 0u);
      __stcs(dst + v, make_float4((float)c.x * scale, (float)c.y * scale,
                                  (float)c.z * scale, (float)c.w * scale));
    }
    __syncthreads();
  }
}

// The hi-blocked kernel's resident blocks per SM times the SM count, worked out
// (and its shared-memory attributes set) once per device and slice size.
struct HiblockedGrid {
  int smem = 0;
  int resident = 0;
};
constexpr int kMaxDevices = 64;
std::mutex hiblocked_grid_lock;
HiblockedGrid hiblocked_grid[kMaxDevices];

cudaError_t hiblocked_resident(int device, int smem, int* resident) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(hiblocked_grid_lock);
  HiblockedGrid& g = hiblocked_grid[device];
  if (g.smem != smem) {
    cudaError_t err = cudaFuncSetAttribute(
        count_hiblocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(count_hiblocked_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_hiblocked_kernel,
                                                        kHiThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    g.smem = smem;
    g.resident = sms * per_sm;
  }
  *resident = g.resident;
  return cudaSuccess;
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

// Hi-blocked shared-memory histogram, 8 <= k <= 15: slices of 2^slice_log2 int32
// bins.  `out` holds m * 4^k float32 and is written whole.  Returns a cudaError_t
// (0 = launched).
int seekr_count_kmers_hiblocked(const void* bases, const void* lengths, void* out, int64_t m,
                                int64_t lpad, int k, int scaled, int slice_log2, int device,
                                void* stream) {
  if (k < 8 || k > 15 || m < 1 || m > 0x7fffffff || lpad < k) return (int)cudaErrorInvalidValue;
  if (slice_log2 < 3 || slice_log2 > 14 || slice_log2 > 2 * k)  // <= 64 KB of int32 bins
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)sizeof(unsigned int) << slice_log2;
  int resident = 0;
  err = hiblocked_resident(device, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_tiles = m << (2 * k - slice_log2);
  const unsigned int grid = (unsigned int)(n_tiles < resident ? n_tiles : resident);
  count_hiblocked_kernel<<<grid, kHiThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)bases, (const int*)lengths, (float*)out, m, lpad, k, slice_log2, scaled);
  return (int)cudaGetLastError();
}

}  // extern "C"
