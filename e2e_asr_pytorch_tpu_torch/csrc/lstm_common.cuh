// Shared pieces of the single-direction LSTM recurrence kernels for Hopper
// (lstm_fwd.cu, lstm_bwd.cu): the block-wide bf16 tensor-core product
//
//     acc[rows, N] += A[rows, K] * Wt[N, K]^T        (f32 accumulation)
//
// that both the forward step (A = bf16(h_prev), Wt = the block's gate
// columns of w_h) and the backward step (A = bf16(dgates_prev), Wt = the
// block's rows of w_h) are made of, and the cooperative launch.
//
// A is streamed from global memory (through L2: other blocks wrote it before
// the last grid barrier) in k-chunks of kKC bf16 values with cp.async into a
// ring of kStages shared-memory buffers; Wt is either RESIDENT in shared
// memory for the whole sequence or streamed in the same ring. Each warp owns
// whole 16-row tiles of the output and runs mma.sync m16n8k16 on fragments
// read with ldmatrix; staged rows are padded by 8 values (16 bytes), which
// makes every ldmatrix phase hit 8 different bank groups.

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
constexpr int kRowBlock = 128;   // batch rows per pass: one m16 tile per warp
constexpr int kKC = 64;          // bf16 values of the k axis per stage
constexpr int kKS = kKC + 8;     // padded row stride of a staged chunk
constexpr int kStages = 3;       // cp.async ring depth (6 measured no faster)

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);
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

// The A fragment of a warp's 16-row tile for the k16 step at `kk` of a
// staged chunk (row stride kKS): lane l addresses row l%16, k half l/16.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const bf16* a_st,
                                            int mt, int kk, int lane) {
  ldmatrix_x4(a, a_st + (mt * 16 + (lane & 15)) * kKS + kk + (lane >> 4) * 8);
}

// `rows` rows of `klen` bf16 values (klen % 8 == 0) from src (row stride ld)
// into a staged chunk (row stride kKS), 16 bytes per cp.async.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t ld, int rows, int klen) {
  if (klen == kKC) {  // a whole chunk: 8 pieces a row, no division
    for (int i = threadIdx.x; i < rows * (kKC / 8); i += kThreads) {
      const int r = i / (kKC / 8);
      const int p = i % (kKC / 8);
      cp_async16(dst + r * kKS + p * 8, src + (size_t)r * ld + p * 8);
    }
    return;
  }
  const int ppr = klen >> 3;
  const int total = rows * ppr;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / ppr;
    const int p = i - r * ppr;
    cp_async16(dst + r * kKS + p * 8, src + (size_t)r * ld + p * 8);
  }
}

// The k16 steps of one staged chunk: unrolled for a whole chunk, so that the
// fragment loads of its steps overlap instead of queueing behind each mma.
template <typename F>
__device__ __forceinline__ void for_k16(int klen, F&& step) {
  if (klen == kKC) {
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) step(kk);
  } else {
    for (int kk = 0; kk < klen; kk += 16) step(kk);
  }
}

// The k loop of one block-wide product. Streams `nrows` rows of A (and,
// unless RESIDENT, `n_w` rows of Wt) through the ring and calls
// compute(stage, k0, klen) once per chunk, after the chunk has landed for
// every thread. Rows of A beyond nrows are left as they are: each output row
// depends on its own A row only, and those outputs are never stored.
template <bool RESIDENT, typename F>
__device__ __forceinline__ void stream_k(const bf16* a_g, size_t lda, int nrows,
                                         const bf16* w_g, size_t ldw, int n_w,
                                         bf16* a_s, bf16* w_s, int K,
                                         F&& compute) {
  const int nchunks = (K + kKC - 1) / kKC;
  auto fetch = [&](int c) {
    const int k0 = c * kKC;
    const int klen = min(kKC, K - k0);
    const int st = c % kStages;
    stage_rows(a_s + st * kRowBlock * kKS, a_g + k0, lda, nrows, klen);
    if (!RESIDENT) stage_rows(w_s + st * n_w * kKS, w_g + k0, ldw, n_w, klen);
  };
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) fetch(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's did, and chunk c-1's buffer is free
    if (c + kStages - 1 < nchunks) fetch(c + kStages - 1);
    cp_async_commit();
    const int k0 = c * kKC;
    compute(c % kStages, k0, min(kKC, K - k0));
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next product
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

inline size_t ring_bytes(int n_w_streamed) {
  return sizeof(bf16) * (size_t)kStages * kKS * (kRowBlock + n_w_streamed);
}
inline size_t resident_bytes(int n_w, int K) {
  return sizeof(bf16) * (size_t)n_w * (K + 8);
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
