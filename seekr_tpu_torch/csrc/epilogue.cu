// The forward's operand epilogue for Hopper (sm_90a): from the count buffer to the
// split Gram's TF32 halves in four streaming passes.
//
// No TPU counterpart: seekr_tpu's normalize and Pearson are plain XLA, and the port
// first ran them as a chain of PyTorch elementwise launches (ops/normalize.py,
// ops/pearson.py).  These kernels were added for the H100, where that chain held
// about half of every all-pairs forward at a few percent of HBM bandwidth.  The
// plain PyTorch twins of every kernel, with the same arithmetic, are in
// seekr_tpu_torch/ops/epilogue_cuda.py.
//
//   epilogue_column_stats_kernel       the normalize chain's column statistics (one read)
//   epilogue_normalize_kernel          the chain's elementwise steps, in place (read, write)
//   epilogue_row_stats_kernel          each row's moments for the row standardization (read)
//   epilogue_standardize_split_kernel  the standardized operand's TF32 halves (read, 2 writes)
//
// Each works on one column block of GEMM_CHUNK columns of the row-major [m, n]
// float32 buffer (base + c0, row stride n), as the launcher's block loop hands it.
//
// What bounds them: bytes.  Per element the work is a few float32 operations (two
// accurate_log2 in Log2.pre) and a few float64 adds; the floor is one read of the
// buffer per statistics pass and one read and write per apply pass, and each kernel
// reads and writes 16 bytes a thread with enough blocks in flight to fill 132 SMs.
//
// Arithmetic:
// * Every reduction is accumulated in float64: a column's sum and sum of squares
//   of (y - pivot), the pivot its row-0 value, per block of 512 rows, then the blocks
//   in a fixed order (deterministic); a row's the same over its columns, pivot its
//   column-0 value, warp by warp and block by block.  The mean and the population
//   std are rounded to float32 from them.
// * Every elementwise step is the torch chain's float32 operation in the same order
//   (__fadd_rn and friends: no FMA contraction), so given the same statistics and
//   shift each element is bitwise what the chain writes; the TF32 split is
//   ops/pearson.round_to_tf32's integer rounding.  Build without --use_fast_math.
// * Log2.post's shift is |min| of the standardized matrix.  Rounding is monotone, so
//   for a finite nonzero std a column's min is fl(fl(y_min - mean) / std) (y_max's
//   for a negative std); a non-finite value with a computed statistic makes the
//   column NaN, as the chain's statistics do; a constant column gives its one
//   value; only a zero std on a column that is not constant (a zero std handed in)
//   is scanned.  With both statistics given (or skipped) the min is taken of the
//   standardized values themselves.  NaN carries through every min, as torch.min's.
//
// The column statistics are one launch: the last block of each 128-column tile (an
// atomic count) combines the tile's partial sums, and the last tile folds the
// block's minimum into a running minimum over the column blocks, which the apply
// kernel reads.  The launcher's counters start at zero and each launch leaves them
// so; nothing here synchronizes with the host.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 128;   // 32 threads x 4 columns
constexpr int kRowLanes = 8;     // warps of a column-statistics block, each a row lane
constexpr int kChunkRows = 512;  // rows of one column-statistics block
constexpr int kApplyRows = 16;   // rows of one apply block
constexpr int kUnroll = 4;       // 16-byte loads a thread keeps in flight

enum { kSkip = 0, kGiven = 1, kComputed = 2 };

constexpr float kInv9 = (float)(1.0 / 9.0);
constexpr float kInv7 = (float)(1.0 / 7.0);
constexpr float kInv5 = (float)(1.0 / 5.0);
constexpr float kInv3 = (float)(1.0 / 3.0);
constexpr float kInvLn2 = (float)1.4426950408889634;
constexpr float kSqrt2 = (float)1.4142135623730951;
constexpr float kMinNormal = 1.17549435e-38f;
constexpr float kTf32Max = 0x1.ffcp+127f;  // (2 - 2^-10) * 2^127, TF32's largest

// ops/math.accurate_log2, operation for operation.
__device__ __forceinline__ float accurate_log2(float x) {
  const int xi = __float_as_int(x);
  int e = ((xi >> 23) & 0xFF) - 127;
  float m = __int_as_float((xi & 0x007FFFFF) | (127 << 23));
  if (m > kSqrt2) {
    m = __fmul_rn(m, 0.5f);
    e += 1;
  }
  const float s = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float s2 = __fmul_rn(s, s);
  float p = __fadd_rn(__fmul_rn(s2, kInv9), kInv7);
  p = __fadd_rn(__fmul_rn(p, s2), kInv5);
  p = __fadd_rn(__fmul_rn(p, s2), kInv3);
  p = __fadd_rn(__fmul_rn(p, s2), 1.0f);
  const float log_m = __fmul_rn(__fmul_rn(2.0f, s), p);
  const float result = __fadd_rn((float)e, __fmul_rn(log_m, kInvLn2));
  return (x >= kMinNormal && isfinite(x)) ? result : log2f(x);
}

// ops/pearson.round_to_tf32: clamp (NaN kept), add half of the lowest kept bit and
// clear the 13 below it in int32 (wrapping), then + x * 0 (NaN unless x is finite).
__device__ __forceinline__ float round_to_tf32(float x) {
  const float y = isnan(x) ? x : fminf(fmaxf(x, -kTf32Max), kTf32Max);
  const unsigned bits = (__float_as_uint(y) + 4096u) & 0xFFFFE000u;
  return __fadd_rn(__uint_as_float(bits), __fmul_rn(x, 0.0f));
}

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The value the chain normalizes: Log2.pre's accurate_log2(x + 1), else x.
__device__ __forceinline__ float transformed(float x, int pre) {
  return pre ? accurate_log2(__fadd_rn(x, 1.0f)) : x;
}

__device__ __forceinline__ float standardized(float y, int mean_mode, float mu, int std_mode,
                                              float sd) {
  if (mean_mode != kSkip) y = __fsub_rn(y, mu);
  if (std_mode != kSkip) y = __fdiv_rn(y, sd);
  return y;
}

// Mean and population std, rounded to float32, of n values from the float64 sums of
// their differences from `pivot`; the launcher's plain twin computes the same.
__device__ __forceinline__ void moments_to_stats(double s, double q, double n, float pivot,
                                                 float* mean, float* std) {
  const double mean_d = __ddiv_rn(s, n);
  double var = __dsub_rn(__ddiv_rn(q, n), __dmul_rn(mean_d, mean_d));
  if (var < 0.0) var = 0.0;  // NaN stays
  *mean = __double2float_rn(__dadd_rn((double)pivot, mean_d));
  *std = __double2float_rn(__dsqrt_rn(var));
}

struct ColumnStats {
  const float* base;   // the [m, n] buffer
  int64_t m, n, c0;    // rows, row stride (= columns), the block's first column
  int width;           // columns of the block, a multiple of 4
  int pre, mean_mode, std_mode, need_min;
  const float* mean_in;  // given statistics, full width (or null)
  const float* std_in;
  float* mean_out;       // computed statistics, full width (or null)
  float* std_out;
  double* part_s;        // [chunks, width] partial sums of the row blocks
  double* part_q;
  float* part_lo;        // [chunks, width] min of y (or of z, both statistics given)
  float* part_hi;        // [chunks, width] max of y
  float* tile_min;       // [tiles] each tile's min of the standardized values
  unsigned* counters;    // [tiles + 1], zero on entry and on exit
  float* running;        // [blocks] min over the column blocks so far
  int block;             // index of this column block
};

// A column's min of the standardized values by a scan of all its rows: the case
// the endpoints cannot decide (a zero std on a column that is not constant).
__device__ float scanned_min(const ColumnStats& a, int64_t col, float mu, float sd) {
  float z_min = CUDART_INF_F;
  for (int64_t r = 0; r < a.m; ++r) {
    const float y = transformed(a.base[r * a.n + col], a.pre);
    z_min = nan_min(z_min, standardized(y, a.mean_mode, mu, a.std_mode, sd));
    if (z_min != z_min) break;
  }
  return z_min;
}

__device__ float block_min(float v, float* scratch) {
  // NaN-propagating min over the block's threads; the result in every thread
  scratch[threadIdx.x] = v;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
      scratch[threadIdx.x] = nan_min(scratch[threadIdx.x], scratch[threadIdx.x + stride]);
    __syncthreads();
  }
  const float out = scratch[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
epilogue_column_stats_kernel(const ColumnStats a) {
  __shared__ double sh_s[kRowLanes][kTileCols];
  __shared__ double sh_q[kRowLanes][kTileCols];
  __shared__ float sh_lo[kRowLanes][kTileCols];
  __shared__ float sh_hi[kRowLanes][kTileCols];
  __shared__ float sh_min[kThreads];
  __shared__ int sh_last;

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int chunks = gridDim.y;
  const bool sums = a.mean_mode == kComputed || a.std_mode == kComputed;
  const int j = tile * kTileCols + tx * 4;  // this thread's first column in the block
  const int64_t r0 = (int64_t)blockIdx.y * kChunkRows;
  const int64_t r1 = r0 + kChunkRows < a.m ? r0 + kChunkRows : a.m;

  double s[4] = {0.0, 0.0, 0.0, 0.0}, q[4] = {0.0, 0.0, 0.0, 0.0};
  float lo[4] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  if (j < a.width) {
    const float* col = a.base + a.c0 + j;
    float pv[4], mu[4], sd[4];
    if (sums) {
      const float4 p = __ldg(reinterpret_cast<const float4*>(col));
      for (int i = 0; i < 4; ++i) pv[i] = transformed(lane(p, i), a.pre);
    } else {
      for (int i = 0; i < 4; ++i) {
        mu[i] = a.mean_mode == kGiven ? a.mean_in[a.c0 + j + i] : 0.0f;
        sd[i] = a.std_mode == kGiven ? a.std_in[a.c0 + j + i] : 1.0f;
      }
    }
#pragma unroll 4
    for (int64_t r = r0 + ty; r < r1; r += kRowLanes) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(col + r * a.n));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float y = transformed(lane(v, i), a.pre);
        if (sums) {
          const double d = (double)y - (double)pv[i];
          s[i] += d;
          q[i] = fma(d, d, q[i]);
          lo[i] = nan_min(lo[i], y);
          hi[i] = nan_max(hi[i], y);
        } else {
          lo[i] = nan_min(lo[i], standardized(y, a.mean_mode, mu[i], a.std_mode, sd[i]));
        }
      }
    }
  }
  for (int i = 0; i < 4; ++i) {
    sh_s[ty][tx * 4 + i] = s[i];
    sh_q[ty][tx * 4 + i] = q[i];
    sh_lo[ty][tx * 4 + i] = lo[i];
    sh_hi[ty][tx * 4 + i] = hi[i];
  }
  __syncthreads();

  // this block's partials, the row lanes added in order
  const int c = threadIdx.x;  // < kTileCols: one column each
  const int jc = tile * kTileCols + c;
  const bool own = c < kTileCols && jc < a.width;
  if (own) {
    double S = 0.0, Q = 0.0;
    float L = CUDART_INF_F, H = -CUDART_INF_F;
    for (int l = 0; l < kRowLanes; ++l) {
      S += sh_s[l][c];
      Q += sh_q[l][c];
      L = nan_min(L, sh_lo[l][c]);
      H = nan_max(H, sh_hi[l][c]);
    }
    const int64_t o = (int64_t)blockIdx.y * a.width + jc;
    a.part_s[o] = S;
    a.part_q[o] = Q;
    a.part_lo[o] = L;
    a.part_hi[o] = H;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh_last = atomicAdd(&a.counters[tile], 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (!sh_last) return;

  // the last block of this tile: the chunks in order, then each column's statistics
  float z_min = CUDART_INF_F;
  if (own) {
    double S = 0.0, Q = 0.0;
    float L = CUDART_INF_F, H = -CUDART_INF_F;
    for (int k = 0; k < chunks; ++k) {
      const int64_t o = (int64_t)k * a.width + jc;
      S += __ldcg(a.part_s + o);
      Q += __ldcg(a.part_q + o);
      L = nan_min(L, __ldcg(a.part_lo + o));
      H = nan_max(H, __ldcg(a.part_hi + o));
    }
    const int64_t col = a.c0 + jc;
    if (!sums) {
      z_min = L;
    } else {
      const float pivot = transformed(a.base[col], a.pre);
      float mean32, std32;
      moments_to_stats(S, Q, (double)a.m, pivot, &mean32, &std32);
      float mu = 0.0f, sd = 1.0f;
      if (a.mean_mode == kComputed) {
        a.mean_out[col] = mean32;
        mu = mean32;
      } else if (a.mean_mode == kGiven) {
        mu = a.mean_in[col];
      }
      if (a.std_mode == kComputed) {
        a.std_out[col] = std32;
        sd = std32;
      } else if (a.std_mode == kGiven) {
        sd = a.std_in[col];
      }
      if (a.need_min) {
        if (!(isfinite(L) && isfinite(H))) {
          z_min = CUDART_NAN_F;  // a computed statistic over a NaN or inf is NaN or spreads it
        } else {
          const float z_lo = standardized(L, a.mean_mode, mu, a.std_mode, sd);
          const float z_hi = standardized(H, a.mean_mode, mu, a.std_mode, sd);
          if (z_lo != z_lo || z_hi != z_hi)
            z_min = CUDART_NAN_F;
          else if (a.std_mode != kSkip && sd == 0.0f && L != H)
            z_min = scanned_min(a, col, mu, sd);
          else
            z_min = fminf(z_lo, z_hi);
        }
      }
    }
  }
  if (threadIdx.x == 0) a.counters[tile] = 0u;
  if (!a.need_min) return;
  z_min = block_min(z_min, sh_min);
  if (threadIdx.x == 0) a.tile_min[tile] = z_min;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sh_last = atomicAdd(&a.counters[gridDim.x], 1u) == (unsigned)(gridDim.x - 1);
  __syncthreads();
  if (!sh_last) return;

  // the last tile: the block's minimum, folded into the running one
  float b = CUDART_INF_F;
  for (int t = threadIdx.x; t < (int)gridDim.x; t += kThreads) b = nan_min(b, __ldcg(a.tile_min + t));
  b = block_min(b, sh_min);
  if (threadIdx.x == 0) {
    a.running[a.block] = a.block == 0 ? b : nan_min(a.running[a.block - 1], b);
    a.counters[gridDim.x] = 0u;
  }
}

struct Normalize {
  float* base;
  int64_t m, n, c0;
  int width;
  int pre, post;
  const float* mean;   // full width, or null (skipped)
  const float* std;
  const float* shift;  // the running minimum of the last column block (Log2.post)
};

__device__ __forceinline__ float normalized(float x, const Normalize& a, float mu, float sd,
                                            float shift) {
  float y = transformed(x, a.pre);
  if (a.mean) y = __fsub_rn(y, mu);
  if (a.std) y = __fdiv_rn(y, sd);
  if (a.post) y = accurate_log2(__fadd_rn(__fadd_rn(y, shift), 1.0f));
  return y;
}

__global__ void __launch_bounds__(kThreads)
epilogue_normalize_kernel(const Normalize a) {
  const int w4 = a.width >> 2;
  const int64_t r0 = (int64_t)blockIdx.x * kApplyRows;
  const int rows = (int)(a.m - r0 < kApplyRows ? a.m - r0 : kApplyRows);
  const int total = rows * w4;
  const float shift = a.post ? fabsf(*a.shift) : 0.0f;
  for (int i0 = threadIdx.x; i0 < total; i0 += kUnroll * kThreads) {
    float4 v[kUnroll];
    float4* at[kUnroll];
    int col[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        const int r = i / w4;
        col[u] = (i - r * w4) * 4;
        at[u] = reinterpret_cast<float4*>(a.base + (r0 + r) * a.n + a.c0 + col[u]);
        v[u] = *at[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads < total) {
        const int64_t c = a.c0 + col[u];
        float4 mu = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sd = mu;
        if (a.mean) mu = __ldg(reinterpret_cast<const float4*>(a.mean + c));
        if (a.std) sd = __ldg(reinterpret_cast<const float4*>(a.std + c));
        float4 o;
        o.x = normalized(v[u].x, a, mu.x, sd.x, shift);
        o.y = normalized(v[u].y, a, mu.y, sd.y, shift);
        o.z = normalized(v[u].z, a, mu.z, sd.z, shift);
        o.w = normalized(v[u].w, a, mu.w, sd.w, shift);
        *at[u] = o;
      }
    }
  }
}

// Each warp one row of the block: the sums of (y - y[row, 0]) and of its square,
// added to the row's float64 totals (written at the first block).
__global__ void __launch_bounds__(kThreads)
epilogue_row_stats_kernel(const float* __restrict__ base, int64_t m, int64_t n, int64_t c0,
                          int width, int first, double* __restrict__ row_s,
                          double* __restrict__ row_q) {
  const int ln = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= m) return;
  const float* row = base + r * n;
  const double pivot = (double)__ldg(row);
  const float4* v4 = reinterpret_cast<const float4*>(row + c0);
  const int w4 = width >> 2;
  double s = 0.0, q = 0.0;
  for (int c0w = ln; c0w < w4; c0w += kUnroll * 32) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c0w + u * 32 < w4) v[u] = __ldg(v4 + c0w + u * 32);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0w + u * 32 < w4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double d = (double)lane(v[u], i) - pivot;
          s += d;
          q = fma(d, d, q);
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  if (ln == 0) {
    row_s[r] = first ? s : row_s[r] + s;
    row_q[r] = first ? q : row_q[r] + q;
  }
}

// Each warp one row of the block: a = (y - mean) / std in float32, from the row's
// float64 moments, and its TF32 halves hi = tf32(a), lo = tf32(a - hi) into the
// [m, width] scratch.
__global__ void __launch_bounds__(kThreads)
epilogue_standardize_split_kernel(const float* __restrict__ base, int64_t m, int64_t n,
                                  int64_t c0, int width, const double* __restrict__ row_s,
                                  const double* __restrict__ row_q, float* __restrict__ hi,
                                  float* __restrict__ lo) {
  const int ln = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= m) return;
  const float* row = base + r * n;
  float mu, sd;
  moments_to_stats(row_s[r], row_q[r], (double)n, __ldg(row), &mu, &sd);
  const float4* v4 = reinterpret_cast<const float4*>(row + c0);
  float4* h4 = reinterpret_cast<float4*>(hi + r * width);
  float4* l4 = reinterpret_cast<float4*>(lo + r * width);
  const int w4 = width >> 2;
  for (int c0w = ln; c0w < w4; c0w += kUnroll * 32) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c0w + u * 32 < w4) v[u] = __ldg(v4 + c0w + u * 32);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0w + u * 32 < w4) {
        float h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = __fdiv_rn(__fsub_rn(lane(v[u], i), mu), sd);
          h[i] = round_to_tf32(av);
          l[i] = round_to_tf32(__fsub_rn(av, h[i]));
        }
        h4[c0w + u * 32] = make_float4(h[0], h[1], h[2], h[3]);
        l4[c0w + u * 32] = make_float4(l[0], l[1], l[2], l[3]);
      }
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool bad_block(int64_t m, int64_t n, int64_t c0, int width) {
  return m < 1 || width < 4 || width % 4 != 0 || n % 4 != 0 || c0 % 4 != 0 || c0 < 0 ||
         c0 + width > n;
}

}  // namespace

extern "C" {

// Bytes of scratch one column-statistics launch of `width` columns over `m` rows
// needs: the partial sums and extremes of each block of rows, and the tile minima.
int64_t seekr_epilogue_scratch_bytes(int64_t m, int width) {
  const int64_t chunks = ceil_div(m, kChunkRows);
  return chunks * width * (2 * sizeof(double) + 2 * sizeof(float)) +
         ceil_div(width, kTileCols) * sizeof(float);
}

// Counters the column-statistics launches of one stream share: one a tile, one more.
int seekr_epilogue_counters(int width) { return (int)ceil_div(width, kTileCols) + 1; }

// One column block's statistics.  mean_mode/std_mode: 0 skipped, 1 given (mean_in /
// std_in, full width), 2 computed (into mean_out / std_out, full width).  With
// need_min, running[block] becomes the min of the standardized values over blocks
// 0..block.  Returns a cudaError_t (0 = launched).
int seekr_epilogue_column_stats(const void* base, int64_t m, int64_t n, int64_t c0, int width,
                                int pre, int mean_mode, int std_mode, int need_min,
                                const void* mean_in, const void* std_in, void* mean_out,
                                void* std_out, void* scratch, void* counters, void* running,
                                int block, int device, void* stream) {
  if (bad_block(m, n, c0, width) || mean_mode < 0 || mean_mode > 2 || std_mode < 0 ||
      std_mode > 2 || block < 0 || ceil_div(m, kChunkRows) > 65535)
    return (int)cudaErrorInvalidValue;
  if ((mean_mode == kGiven && !mean_in) || (std_mode == kGiven && !std_in) ||
      (mean_mode == kComputed && !mean_out) || (std_mode == kComputed && !std_out) ||
      (need_min && !running) || !scratch || !counters)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t chunks = ceil_div(m, kChunkRows);
  const int tiles = (int)ceil_div(width, kTileCols);
  ColumnStats a;
  a.base = (const float*)base;
  a.m = m;
  a.n = n;
  a.c0 = c0;
  a.width = width;
  a.pre = pre;
  a.mean_mode = mean_mode;
  a.std_mode = std_mode;
  a.need_min = need_min;
  a.mean_in = (const float*)mean_in;
  a.std_in = (const float*)std_in;
  a.mean_out = (float*)mean_out;
  a.std_out = (float*)std_out;
  char* p = (char*)scratch;
  a.part_s = (double*)p;
  p += chunks * width * sizeof(double);
  a.part_q = (double*)p;
  p += chunks * width * sizeof(double);
  a.part_lo = (float*)p;
  p += chunks * width * sizeof(float);
  a.part_hi = (float*)p;
  p += chunks * width * sizeof(float);
  a.tile_min = (float*)p;
  a.counters = (unsigned*)counters;
  a.running = (float*)running;
  a.block = block;
  epilogue_column_stats_kernel<<<dim3(tiles, (unsigned)chunks), kThreads, 0,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The chain's elementwise steps on one column block, in place.  mean/std: full
// width, or null for a skipped step; shift: the running minimum (Log2.post).
int seekr_epilogue_normalize(void* base, int64_t m, int64_t n, int64_t c0, int width, int pre,
                             int post, const void* mean, const void* std, const void* shift,
                             int device, void* stream) {
  if (bad_block(m, n, c0, width) || (post && !shift)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Normalize a;
  a.base = (float*)base;
  a.m = m;
  a.n = n;
  a.c0 = c0;
  a.width = width;
  a.pre = pre;
  a.post = post;
  a.mean = (const float*)mean;
  a.std = (const float*)std;
  a.shift = (const float*)shift;
  epilogue_normalize_kernel<<<(unsigned)ceil_div(m, kApplyRows), kThreads, 0,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// One column block's contribution to each row's float64 moments (written at the
// first block, added after it).
int seekr_epilogue_row_stats(const void* base, int64_t m, int64_t n, int64_t c0, int width,
                             int first, void* row_s, void* row_q, int device, void* stream) {
  if (bad_block(m, n, c0, width)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  epilogue_row_stats_kernel<<<(unsigned)ceil_div(m, kWarps), kThreads, 0,
                              (cudaStream_t)stream>>>((const float*)base, m, n, c0, width,
                                                      first, (double*)row_s, (double*)row_q);
  return (int)cudaGetLastError();
}

// One column block standardized by the rows' moments and split into TF32 halves,
// written into the [m, width] scratch hi and lo.
int seekr_epilogue_standardize_split(const void* base, int64_t m, int64_t n, int64_t c0,
                                     int width, const void* row_s, const void* row_q, void* hi,
                                     void* lo, int device, void* stream) {
  if (bad_block(m, n, c0, width)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  epilogue_standardize_split_kernel<<<(unsigned)ceil_div(m, kWarps), kThreads, 0,
                                      (cudaStream_t)stream>>>(
      (const float*)base, m, n, c0, width, (const double*)row_s, (const double*)row_q,
      (float*)hi, (float*)lo);
  return (int)cudaGetLastError();
}

}  // extern "C"
