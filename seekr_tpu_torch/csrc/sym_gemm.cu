// The forward's self Gram for Hopper (sm_90a): a symmetric split-TF32 GEMM over the
// upper triangle of r, with r written once.
//
// No TPU counterpart: seekr_tpu's Pearson Gram is plain XLA.  The port ran it as
// cuBLAS TF32 products (ops/pearson.split_gram before this kernel): X = hi lo^T,
// X + X^T, and hi hi^T as eight 512-column addmm_ products, then a divide.  Those
// computed both triangles of a symmetric result and passed the 676 MB r of the k = 6
// forward through HBM about 22 times.  This kernel computes each 128 x 128 output
// tile (I, J) with I <= J once, adds the previous column blocks' sum where there is
// one, and on the last block divides by n and stores the tile and its mirror.  The
// plain PyTorch twin, with the same sums in the same order of folds, is
// seekr_tpu_torch/ops/sym_gemm_cuda.py (sym_split_gemm_plain).
//
// The arithmetic.  The operand a is split into TF32 halves a = hi + lo (the
// epilogue's standardize-split kernel or ops/pearson.split_tf32), so
// a_i . a_j = hi_i.hi_j + hi_i.lo_j + lo_i.hi_j (lo.lo, 2^-22 of the whole, is
// dropped), each product exact in float32.  The tensor cores' float32 sums are not
// rounded to nearest: their error grows with the magnitude of the accumulator and
// the number of wgmma instructions added into it.  So the three products of
// kFoldColumns columns (ops/sym_gemm_cuda.TF32_SUM_COLUMNS) go into one tensor-core
// accumulator P, which is then added to a float32 register total T with a
// round-to-nearest add, and P restarts.  A column block's T is added to the r already written by the
// blocks before it (prev + T), and the last block's sum is divided by n with an
// IEEE divide (__fdiv_rn, as ops/pearson.divide).  Below the diagonal of a diagonal
// tile each element is its mirror's value, so r is exactly symmetric; a NaN row of
// the halves gives a NaN row and column.
//
// What bounds it: operations.  Three TF32 products over the upper triangle, about
// 3 m^2 w operations a block (2.1e12 at m = 13,000, w = 4,096: 4.2 ms at the
// 494.7 TFLOP/s TF32 peak); r is read and written once a block.
//
// The design.  One persistent block per SM walks the tile plan (the launcher's
// tile_plan: bands of 8 tile rows, column by column, so the tiles in flight share
// few operand rows in L2).  A producer warp keeps a ring of 3 shared-memory stages
// full with TMA loads (32 columns of the four operand tiles hi_I, lo_I, hi_J, lo_J,
// 128-byte swizzled, 64 KB a stage); two consumer warpgroups each run wgmma
// m64n128k8 on 64 rows of the tile, keep one group of wgmma in flight, and release
// a stage once its group has completed.  The TMA zero-fills rows past m and columns
// past w, so neither need be a multiple of the tile.  The epilogue stores from
// registers: in the accumulator layout each warp's stores fill whole 32-byte
// sectors, for the tile and for its transpose.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;                    // output tile edge
constexpr int kK = 32;                        // columns of a stage: 128 bytes of float32
constexpr int kStages = 3;
constexpr int kConsumers = 2;                 // warpgroups of wgmma, 64 tile rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kOperandBytes = kTile * kK * 4;  // one operand tile of a stage, 16 KB
constexpr int kStageBytes = 4 * kOperandBytes;  // hi_I, lo_I, hi_J, lo_J
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
// Columns of one fold: the three products summed on the tensor cores before a
// round-to-nearest float32 add (ops/sym_gemm_cuda.TF32_SUM_COLUMNS, which the twin uses).
constexpr int kFoldColumns = 128;
constexpr int kFoldSteps = kFoldColumns / kK;
static_assert(kFoldColumns % kK == 0, "a fold is whole stages");
// Registers a thread: the launch gives every thread kLaunchRegs (the most that
// __launch_bounds__ leaves); the producer gives most of its own to the consumers,
// which hold two 64-float accumulators.  The pool stays 384 x kLaunchRegs.
constexpr int kLaunchRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumerThreads * kConsumerRegs + 128 * kProducerRegs <= kThreads * kLaunchRegs,
              "the consumers' registers come from the producer's");

struct Params {
  float* r;        // [m, m]
  int64_t m;
  int ksteps;      // stages of kK columns a tile: ceil(w / kK)
  const int2* plan;  // (I, J) of each tile, in launch order
  int tiles;
  int first;       // no earlier column block: r is not read
  int last;        // divide by n and mirror
  float n;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One [kTile rows x kK columns] box of the tensor map at (column c, row r).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c, int r,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major, 128-byte swizzled tile: 8-row
// groups 1,024 bytes apart (SBO), the start 16-byte units; the tile 1,024-aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads and writes of d across the
// asynchronous wgmma that own them.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, this warpgroup's rows) = A B^T + (accumulate ? d : 0), A [64 x 8] and
// B [128 x 8] TF32 in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads, 1)
    sym_split_gemm_kernel(const __grid_constant__ CUtensorMap hi_map,
                          const __grid_constant__ CUtensorMap lo_map, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzled tiles: 1,024-aligned
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };               // the stage's loads landed
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };  // every consumer is done with it

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler, so each role's path is not a divergent one
  const int group = __shfl_sync(0xFFFFFFFF, (int)threadIdx.x / 128, 0);
  if (group == kConsumers) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumerThreads) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int2 tile = p.plan[t];
        const int row_a = tile.x * kTile, row_b = tile.y * kTile;
        for (int ks = 0; ks < p.ksteps; ++ks) {
          bar_wait(empty(stage), phase ^ 1);
          bar_expect(full(stage), kStageBytes);
          const uint32_t dst = base + stage * kStageBytes;
          const int col = ks * kK;
          tma_load(dst, &hi_map, col, row_a, full(stage));
          tma_load(dst + kOperandBytes, &lo_map, col, row_a, full(stage));
          tma_load(dst + 2 * kOperandBytes, &hi_map, col, row_b, full(stage));
          tma_load(dst + 3 * kOperandBytes, &lo_map, col, row_b, full(stage));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // a consumer warpgroup: rows group * 64 .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc[64], total[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int2 tile = p.plan[t];
      const int ti = tile.x, tj = tile.y;
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] = 0.0f;
      for (int k0 = 0; k0 < p.ksteps; k0 += kFoldSteps) {  // one fold: P, then T += P
        const int k1 = min(k0 + kFoldSteps, p.ksteps);
        int held = -1;  // the stage whose wgmma group may still be in flight
        for (int ks = k0; ks < k1; ++ks) {
          bar_wait(full(stage), phase);
          const uint32_t src = base + stage * kStageBytes;
          const uint64_t a_hi = smem_desc(src + group * (kOperandBytes / 2));
          const uint64_t a_lo = smem_desc(src + kOperandBytes + group * (kOperandBytes / 2));
          const uint64_t b_hi = smem_desc(src + 2 * kOperandBytes);
          const uint64_t b_lo = smem_desc(src + 3 * kOperandBytes);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kK / 8; ++kk) {  // 8 columns (32 bytes, 2 descriptor units) each
            const uint64_t step = 2 * kk;
            wgmma_tf32(acc, a_hi + step, b_hi + step, ks != k0 || kk != 0);
            wgmma_tf32(acc, a_hi + step, b_lo + step, 1);
            wgmma_tf32(acc, a_lo + step, b_hi + step, 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's group is done
          fence_regs(acc);
          if (held >= 0) bar_arrive(empty(held));
          held = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        bar_arrive(empty(held));
#pragma unroll
        for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], acc[i]);
      }

      // accumulator element i: row warp * 16 + lane / 4 (+ 8), column 8 (i / 4) + 2 (lane % 4) (+ 1)
      const int64_t m = p.m;
      const int row0 = ti * kTile + group * 64 + warp * 16 + lane / 4;
      const int col0 = tj * kTile + 2 * (lane % 4);
      if (!p.first) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int row = row0 + ((i >> 1) & 1) * 8, col = col0 + (i >> 2) * 8 + (i & 1);
          if (row < m && col < m) total[i] = __fadd_rn(p.r[row * m + col], total[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int row = row0 + ((i >> 1) & 1) * 8, col = col0 + (i >> 2) * 8 + (i & 1);
        if (row >= m || col >= m) continue;
        if (!p.last) {
          p.r[row * m + col] = total[i];
        } else if (ti != tj || row <= col) {
          const float v = __fdiv_rn(total[i], p.n);
          p.r[row * m + col] = v;
          p.r[col * m + row] = v;
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = (EncodeTiled)sym;
  }
  return fn;
}

// The [m, w] float32 halves (row stride ld) as a TMA map of [kTile x kK] boxes,
// 128-byte swizzled; reads past the edges give zeros.
bool encode(CUtensorMap* map, const void* base, int64_t m, int w, int64_t ld) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {kK, kTile};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// One column block of the symmetric Gram: hi and lo [m, w] (row stride ld, a multiple
// of 4; 16-byte aligned), r [m, m] float32, plan [tiles, 2] int32 (I, J) tile indices.
// first: r holds no earlier block; last: r = (r + block) / n, mirrored.
// Returns a cudaError_t (0 = launched).
int seekr_sym_split_gemm(const void* hi, const void* lo, int64_t ld, void* r, int64_t m, int w,
                         const void* plan, int tiles, int first, int last, float n, int device,
                         void* stream) {
  if (m < 1 || m > INT32_MAX - kTile || w < 1 || ld < w || ld % 4 != 0 || tiles < 1 || !hi ||
      !lo || !r || !plan || (uintptr_t)hi % 16 != 0 || (uintptr_t)lo % 16 != 0 ||
      (uintptr_t)plan % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap hi_map, lo_map;
  if (!encode(&hi_map, hi, m, w, ld) || !encode(&lo_map, lo, m, w, ld))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, sym_split_gemm_kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < kLaunchRegs) return (int)cudaErrorInvalidConfiguration;  // no pool for 232
  err = cudaFuncSetAttribute(sym_split_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.r = (float*)r;
  p.m = m;
  p.ksteps = (w + kK - 1) / kK;
  p.plan = (const int2*)plan;
  p.tiles = tiles;
  p.first = first;
  p.last = last;
  p.n = n;
  const int grid = tiles < sms ? tiles : sms;
  sym_split_gemm_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(hi_map, lo_map, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
