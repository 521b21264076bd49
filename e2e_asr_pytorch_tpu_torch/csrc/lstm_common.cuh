// Shared pieces of the recurrence kernels for Hopper: the LSTM activations
// and paired loads and stores of the chunked LSTM kernels (lstm_fwd.cu,
// lstm_bwd.cu), and the mma.sync pieces, the resident slab's copy and the
// cooperative launch of the split-k kernels (bilstm_fwd.cu, bilstm_bwd.cu
// and, through gru_common.cuh, gru.cu and ligru.cu).
//
// The split-k kernels stream A (bf16(h) or bf16(dgates) of the previous
// step, written by other blocks before the last grid barrier) from L2 with
// cp.async into a ring of shared-memory segments against a slab of Wt that
// stays in shared memory for the whole walk, and run mma.sync m16n8k16 on
// fragments read with ldmatrix; staged rows are padded by 8 values (16
// bytes), which makes every ldmatrix phase hit 8 different bank groups.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;    // threads per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// two adjacent values of a stream, kept as loaded until the cell update
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  typedef float2 type;
};
template <>
struct Pair<bf16> {
  typedef __nv_bfloat162 type;
};
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ __nv_bfloat162 load2(const bf16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ float2 widen(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only (never a stale L1 line)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulation. Not
// volatile: a pure register operation the compiler may move past the
// fragment loads of the next k16 step.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy the block's resident slab of Wt (n_w rows of K values, row stride ld
// in global) into shared memory with row stride K + 8.
__device__ __forceinline__ void load_resident(bf16* w_res, const bf16* src,
                                              size_t ld, int n_w, int K) {
  const int ppr = K >> 3;
  for (int i = threadIdx.x; i < n_w * ppr; i += kThreads) {
    const int r = i / ppr;
    const int p = i - r * ppr;
    *reinterpret_cast<uint4*>(w_res + (size_t)r * (K + 8) + p * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + p * 8);
  }
  __syncthreads();
}

// The cells (row, unit) of a 16-row pass that thread `tid` of a block of
// kThreads updates in the split-k LSTM forward (bilstm_fwd.cu: K1 and
// K5f's narrow form), whose block owns U units: 16 U cells. U = 20: (tid / 16,
// tid % 16) and, for the first 64 threads, (tid / 4, 16 + tid % 4); U <= 16:
// (tid / U, tid % U) for the first 16 U threads. Fills the caller's arrays
// (kept in registers) and returns how many of the two are the thread's.
template <int U>
__device__ __forceinline__ int pass_cells(int tid, int (&rows)[2],
                                          int (&units)[2]) {
  if constexpr (U == 20) {
    rows[0] = tid >> 4;
    rows[1] = tid >> 2;
    units[0] = tid & 15;
    units[1] = 16 + (tid & 3);
    return tid < 64 ? 2 : 1;
  } else {
    static_assert(16 * U <= kThreads, "one cell a thread");
    rows[0] = rows[1] = tid / U;
    units[0] = units[1] = tid % U;
    return tid < 16 * U ? 1 : 0;
  }
}

// One cooperative launch of `kernel` over n_tiles tiles: every block must be
// co-resident for the grid barrier. With one_tile_per_block (a resident
// slab) the grid is exactly n_tiles and the launch is refused when the card
// cannot hold that many blocks; otherwise blocks loop over tiles.
inline int coop_launch(const void* kernel, size_t smem, int n_tiles,
                       bool one_tile_per_block, void** args,
                       cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, n_sm = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    device)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int cap = per_sm * n_sm;
  if (one_tile_per_block && n_tiles > cap)
    return (int)cudaErrorInvalidConfiguration;
  const int grid = n_tiles < cap ? n_tiles : cap;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace lstm
