// The two reductions over an int8 attention value table, for Hopper
// (sm_90a), as in the teacher-forced decoder scan of the training step.
//
//   context_int8 (K3): ctx[b, d]  = sum_t bf16(attn2[b, t]) * q[b, t, d]
//   dattn_int8   (K4): draw[b, t] = sum_d bf16(dctx[b, d]) * q[b, t, d]
//
// q is the (B, T, D) int8 table, attn2 (B, T) and dctx (B, D) are f32 and
// are rounded to bf16 before the product, as the TPU kernels do; products
// are exact in f32 and sums run in f32. Outputs are f32.
//
// Replaces the TPU kernels `_ctx_kernel` / `_context_int8_call` and
// `_dattn_kernel` / `_dattn_int8_call`
// (e2e_asr_pytorch_tpu/ops/pallas/int8_table.py). The TPU version padded the
// table to its (8, 32, 128) tiles and walked 8 batch rows per grid step;
// here any (B, T, D) is taken and each kernel masks its own edges.
//
// Bound on the H100. Both are one pass over the table, launched once per
// decode step each: at the flagship's 16 s bucket the table is
// 16 x 400 x 2560 int8 = 16.4 MB, about 5 us at the card's 3.35 TB/s (it
// also fits the 50 MB L2, where consecutive steps may find it). The small
// operands are kilobytes. So the design is about keeping enough 16-byte
// loads in flight on all SMs:
//
//  * K3 gives each block one (b, D-slice of 32 x 16 bytes): a warp's 32
//    lanes each load 16 consecutive int8 values of a row (one 16-byte load),
//    and the block's 8 warps split the t axis; partial sums meet in shared
//    memory. B = 16, D = 2560 makes 80 blocks of 256 threads.
//  * K4 gives a warp to each (b, t) row: lanes stride over D in 16-byte
//    loads and a shuffle reduction ends the row. A block holds 8 rows of one
//    b and stages bf16(dctx[b]) once in shared memory.
//
// Rows whose D is not a multiple of 16 (a ragged table) take a scalar path.
//
// Plain C interface, loaded with ctypes (see ops/kernels/int8_table.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;  // int8 values per 16-byte load

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// grid (ceil(D / (32 * kVec)), B); block (32, kWarps)
__global__ void __launch_bounds__(kThreads)
context_int8_kernel(const float* __restrict__ attn2,
                    const int8_t* __restrict__ q, float* __restrict__ out,
                    int n_t, int n_d) {
  __shared__ float part[kWarps][32 * kVec];
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int d0 = (blockIdx.x * 32 + lane) * kVec;
  const bool vec = (n_d % kVec) == 0;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
  const int8_t* qb = q + (size_t)b * n_t * n_d;
  const float* ab = attn2 + (size_t)b * n_t;
  if (d0 < n_d) {
#pragma unroll 4
    for (int t = warp; t < n_t; t += kWarps) {
      const float a = bf16_round(__ldg(ab + t));
      const int8_t* row = qb + (size_t)t * n_d + d0;
      if (vec) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(row));
        const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // byte k of the word, sign-extended
            const int x = (int)((unsigned)words[w] << (24 - 8 * k)) >> 24;
            acc[4 * w + k] = fmaf(a, (float)x, acc[4 * w + k]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          if (d0 + i < n_d) acc[i] = fmaf(a, (float)row[i], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) part[warp][lane * kVec + i] = acc[i];
  __syncthreads();
  // 512 outputs per block, 256 threads: two each, summed over the warps
  for (int o = warp * 32 + lane; o < 32 * kVec; o += kThreads) {
    const int d = blockIdx.x * 32 * kVec + o;
    if (d < n_d) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][o];
      out[(size_t)b * n_d + d] = s;
    }
  }
}

// grid (ceil(T / kWarps), B); block (32, kWarps); dynamic smem D floats
__global__ void __launch_bounds__(kThreads)
dattn_int8_kernel(const float* __restrict__ dctx,
                  const int8_t* __restrict__ q, float* __restrict__ out,
                  int n_t, int n_d) {
  extern __shared__ float g_s[];  // bf16(dctx[b]) as f32, (D,)
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  for (int d = tid; d < n_d; d += kThreads)
    g_s[d] = bf16_round(dctx[(size_t)b * n_d + d]);
  __syncthreads();
  const int t = blockIdx.x * kWarps + warp;
  if (t >= n_t) return;
  const int8_t* row = q + ((size_t)b * n_t + t) * n_d;
  float acc = 0.0f;
  if ((n_d % kVec) == 0) {
    const int4* row16 = reinterpret_cast<const int4*>(row);
#pragma unroll 4
    for (int c = lane; c < n_d / kVec; c += 32) {
      const int4 v = __ldg(row16 + c);
      const int words[4] = {v.x, v.y, v.z, v.w};
      const float* g = g_s + c * kVec;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // byte k of the word, sign-extended
          const int x = (int)((unsigned)words[w] << (24 - 8 * k)) >> 24;
          acc = fmaf(g[4 * w + k], (float)x, acc);
        }
      }
    }
  } else {
    for (int d = lane; d < n_d; d += 32) acc = fmaf(g_s[d], (float)row[d], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(size_t)b * n_t + t] = acc;
}

}  // namespace

// Both return a cudaError_t code (0 on success). All pointers come from
// contiguous PyTorch tensors: q (B, T, D) int8, attn2 (B, T), dctx (B, D)
// and the outputs f32. A 16-byte aligned table row needs D % 16 == 0 (and
// a 16-byte aligned base, which a fresh allocation has); otherwise the
// kernels read the table byte by byte.
extern "C" int context_int8(const void* attn2, const void* q, void* out,
                            int batch, int n_t, int n_d, void* stream) {
  const dim3 grid((n_d + 32 * kVec - 1) / (32 * kVec), batch);
  context_int8_kernel<<<grid, dim3(32, kWarps), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attn2), static_cast<const int8_t*>(q),
      static_cast<float*>(out), n_t, n_d);
  return (int)cudaGetLastError();
}

extern "C" int dattn_int8(const void* dctx, const void* q, void* out,
                          int batch, int n_t, int n_d, void* stream) {
  const size_t smem = sizeof(float) * (size_t)n_d;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dattn_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_t + kWarps - 1) / kWarps, batch);
  dattn_int8_kernel<<<grid, dim3(32, kWarps), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dctx), static_cast<const int8_t*>(q),
      static_cast<float*>(out), n_t, n_d);
  return (int)cudaGetLastError();
}
