// Hopper's asynchronous machinery as thin PTX wrappers, for the chunked LSTM
// forward and backward (lstm_fwd.cu, lstm_bwd.cu, which replace the TPU
// kernels `_fwd_kernel_chunked` and `_bwd_kernel_chunked` of
// e2e_asr_pytorch_tpu/ops/pallas/lstm.py, and `_fwd_kernel` in its wide
// form and `_bwd_kernel`): mbarriers, bulk copies global -> shared
// (the TMA unit, without a tensor map: contiguous bytes), and the warpgroup
// matrix product `wgmma` on 128-byte-swizzled shared-memory tiles.
//
// What each piece is for on this card: a bulk copy costs one instruction of
// one thread for a whole tile (no registers, no per-16-byte cp.async) and
// reports its bytes to an mbarrier, so a producer warp can keep a ring of
// tiles in flight while the consumers never meet at a block-wide barrier;
// wgmma takes both operands straight from shared memory, where
// mma.sync makes every warp load its own fragments of them first. Only
// sm_90a has all of them.
//
// Layout contract of a swizzled tile. A tile is R rows of 64 bf16 (128
// bytes), K contiguous, based at a 1024-byte-aligned shared address; the
// 16-byte chunk c of row r sits at chunk position c ^ (r % 8) of its row
// (`swizzled_chunk`). Whoever writes the tile's image to global memory
// (the packing of w_h, the cell update that writes bf16(h) or
// bf16(dgates)) applies the permutation there, so one contiguous bulk copy
// lands the tile as wgmma's 128B-swizzle descriptor expects it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kTileK = 64;        // bf16 values per tile row: one swizzle atom
constexpr int kTileRowBytes = 128;

__host__ __device__ __forceinline__ int swizzled_chunk(int row, int chunk) {
  return chunk ^ (row & 7);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(arrivals)
               : "memory");
}
// makes the initialised barriers visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of bulk-copy traffic
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}
// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- proxies and barriers ----------------------------------------------

// orders this thread's generic-proxy accesses (plain loads and stores) with
// async-proxy ones (bulk copies, wgmma operand reads), all state spaces
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// a load that later loads and bulk copies of this thread are ordered after
__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
// barrier `id` (1..15) over the first `threads` threads of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- bulk copies --------------------------------------------------------

// `bytes` (a multiple of 16) contiguous bytes global -> this block's shared
// memory; completion is reported to `bar` as `bytes` of transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}
// ---- wgmma --------------------------------------------------------------

// Descriptor of a K-major tile of 128-byte rows in the 128B swizzle: start
// address, leading offset (unused in this mode) 16 bytes, 1024 bytes from
// one group of eight rows to the next. A k16 step inside the tile advances
// the start address by 32 bytes.
__device__ __forceinline__ uint64_t swizzled_desc(const void* tile) {
  const uint64_t addr = shared_addr(tile);
  uint64_t desc = (addr & 0x3FFFF) >> 4;
  desc |= (uint64_t)(16 >> 4) << 16;
  desc |= (uint64_t)(1024 >> 4) << 32;
  desc |= (uint64_t)1 << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving uses of an accumulator across this point
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32, spread over the warpgroup) += A (64 x 16) * B (64 x 16)^T,
// both bf16 K-major from shared memory. Thread (warp w of the group, lane l)
// holds, for n-tile j = 0..7: d[4j], d[4j+1] = row 16w + l/4, columns
// 8j + 2(l%4) + {0,1}; d[4j+2], d[4j+3] = row 16w + l/4 + 8, same columns.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}


// d (64 x 32 f32) += A (64 x 16) * B (32 x 16)^T, as wgmma_m64n64k16 with
// the n-tiles j = 0..3.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 16 f32) += A (64 x 16) * B (16 x 16)^T, as wgmma_m64n64k16 with
// the n-tiles j = 0..1.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// the k16 step of a 64-row tile against N = 2 x (floats a thread holds)
// columns, picked by the accumulator's size
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  wgmma_m64n64k16(d, a, b);
}
__device__ __forceinline__ void wgmma_k16(float (&d)[16], uint64_t a,
                                          uint64_t b) {
  wgmma_m64n32k16(d, a, b);
}
__device__ __forceinline__ void wgmma_k16(float (&d)[8], uint64_t a,
                                          uint64_t b) {
  wgmma_m64n16k16(d, a, b);
}

}  // namespace hopper
