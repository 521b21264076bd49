// Direction-packed bidirectional LSTM forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bi_fwd_kernel` / `_bilstm_fwd_pallas`
// (e2e_asr_pytorch_tpu/ops/pallas/lstm.py). One launch advances BOTH
// directions of one encoder layer over the whole sequence: at loop step s the
// forward direction consumes data index s and the backward direction data
// index T-1-s, from a zero initial state. Per direction and step
//
//     gates = xg[t] + bf16(h_prev) @ bf16(w_h)      (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid  (gate order i,f,g,o)
//     c = f * c_prev + i * g ;  h = o * tanh(c)     (c and h carried in f32)
//
// ys is written in xg's dtype (f32 or bf16); the bf16 stashes of c and of the
// gate pre-activations (the inputs of the future backward kernel) are written
// only when their pointers are non-null.
//
// Design. The TPU ran the time loop as a sequential grid with both w_h
// resident in VMEM. Here the time loop runs inside ONE persistent cooperative
// launch: each block owns a tile of `ut` hidden units of one direction (the 4
// gate columns of each unit, for all B rows) and keeps that ownership for the
// whole sequence, so each unit's cell state c is read and written only by its
// owner. The hidden state is exchanged through a double-buffered global
// buffer (bf16, which is all the next matmul reads) and a grid-wide barrier
// (cooperative_groups::this_grid().sync()) separates the steps. The grid is
// sized from the occupancy calculator so every block is co-resident; a block
// loops over tiles when there are more tiles than resident blocks.
//
// Bound on the H100. Every step every block re-reads its w_h columns: both
// directions' w_h are 2 * H * 4H bf16 = 26.2 MB at H=1280, which fits the
// 50 MB L2, so the step is bounded by the L2 read of w_h plus one grid
// barrier, and T steps run strictly in sequence. This first version streams
// w_h from L2 every step (the wrapper packs it once per call into per-tile
// contiguous slabs so each row of a slab is one coalesced read); keeping each
// block's slab resident in shared memory (132 SMs x 227 KB just holds
// 26.2 MB), wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes (see ops/kernels/bilstm.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kRows = 8;       // batch rows accumulated in registers at once
constexpr int kUnroll = 8;     // h-axis steps whose w_h loads overlap

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// wp_*: packed w_h, (H/ut, H, 4, ut) bf16 -- tile-major slabs of the 4*ut
//       gate columns a tile owns (column g*H + u0 + j sits at g*ut + j).
// hbuf: (2 directions, 2 buffers, B, H) bf16, buffer 0 zeroed by the caller.
// cbuf: (2 directions, B, H) f32, zeroed by the caller.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_fwd_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                  const __nv_bfloat16* __restrict__ wp_f,
                  const __nv_bfloat16* __restrict__ wp_b, T* ys_f, T* ys_b,
                  __nv_bfloat16* cs_f, __nv_bfloat16* cs_b,
                  __nv_bfloat16* gs_f, __nv_bfloat16* gs_b,
                  __nv_bfloat16* hbuf, float* cbuf, int n_steps, int batch,
                  int hidden, int ut) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  // each thread owns a PAIR of adjacent gate columns of the tile (one 4-byte
  // bf16x2 load per h index) and a strided slice of the h axis
  const int ncols = 4 * ut;
  const int npairs = ncols / 2;
  const int kparts = kThreads / npairs;
  float* red = smem;                          // (kparts, kRows, ncols)
  float* h_s = smem + kparts * kRows * ncols;  // (kRows, hidden), bf16 values
  const int tiles_per_dir = hidden / ut;
  const int n_tiles = 2 * tiles_per_dir;
  const int tid = threadIdx.x;
  const int pair = tid % npairs;
  const int kp = tid / npairs;
  const size_t bh = (size_t)batch * hidden;
  const size_t h4 = (size_t)4 * hidden;
  const bool vec_stage = (hidden % 8) == 0;

  for (int s = 0; s < n_steps; ++s) {
    const int rd = s & 1;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int dir = tile / tiles_per_dir;
      const int tl = tile % tiles_per_dir;
      const int u0 = tl * ut;
      const int t = dir == 0 ? s : n_steps - 1 - s;
      const T* xg = dir == 0 ? xg_f : xg_b;
      T* ys = dir == 0 ? ys_f : ys_b;
      __nv_bfloat16* cs = dir == 0 ? cs_f : cs_b;
      __nv_bfloat16* gs = dir == 0 ? gs_f : gs_b;
      const __nv_bfloat162* w = reinterpret_cast<const __nv_bfloat162*>(
          (dir == 0 ? wp_f : wp_b) + (size_t)tl * hidden * ncols);
      const __nv_bfloat16* h_prev = hbuf + ((size_t)dir * 2 + rd) * bh;
      __nv_bfloat16* h_next = hbuf + ((size_t)dir * 2 + (rd ^ 1)) * bh;
      float* c_state = cbuf + (size_t)dir * bh;

      for (int r0 = 0; r0 < batch; r0 += kRows) {
        const int nr = min(kRows, batch - r0);
        // The chunk has nr*ut <= kRows*8 = 64 cells, one per thread: issue
        // the cell's global loads (xg gates, c) now, ahead of the matmul.
        const bool cell = tid < nr * ut;
        const int cr = cell ? tid / ut : 0;
        const int cj = cell ? tid % ut : 0;
        const size_t row = ((size_t)t * batch + r0 + cr) * h4;
        const size_t bu = (size_t)(r0 + cr) * hidden + u0 + cj;
        float gate[4];
        float c_prev = 0.0f;
        if (cell) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gate[g] = to_f(xg[row + (size_t)g * hidden + u0 + cj]);
          c_prev = __ldcg(c_state + bu);
        }
        // Stage this chunk's rows of h_prev as f32. Other blocks wrote them
        // before the last barrier: read through L2 (ld.global.cg), never
        // from a possibly stale L1 line.
        const size_t n_stage = (size_t)nr * hidden;
        const __nv_bfloat16* src = h_prev + (size_t)r0 * hidden;
        if (vec_stage) {
          const uint4* src8 = reinterpret_cast<const uint4*>(src);
          for (size_t i = tid; i < n_stage / 8; i += kThreads) {
            const uint4 v = __ldcg(src8 + i);
            const unsigned int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              h_s[8 * i + 2 * j] = __uint_as_float(words[j] << 16);
              h_s[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
            }
          }
        } else {
          const unsigned short* src1 =
              reinterpret_cast<const unsigned short*>(src);
          for (size_t i = tid; i < n_stage; i += kThreads)
            h_s[i] = __uint_as_float((unsigned int)__ldcg(src1 + i) << 16);
        }
        __syncthreads();

        float acc0[kRows], acc1[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc0[r] = acc1[r] = 0.0f;
        // partial dot products over this thread's slice of the h axis
#pragma unroll kUnroll
        for (int k = kp; k < hidden; k += kparts) {
          const float2 wv = __bfloat1622float2(w[(size_t)k * npairs + pair]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nr) {
              const float hv = h_s[(size_t)r * hidden + k];
              acc0[r] = fmaf(hv, wv.x, acc0[r]);
              acc1[r] = fmaf(hv, wv.y, acc1[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float* dst = red + (kp * kRows + r) * ncols + 2 * pair;
          dst[0] = acc0[r];
          dst[1] = acc1[r];
        }
        __syncthreads();

        // cell update, one thread per (row, unit) of the tile
        if (cell) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int cc = g * ut + cj;
            float sum = 0.0f;
            for (int p = 0; p < kparts; ++p)
              sum += red[(p * kRows + cr) * ncols + cc];
            gate[g] += sum;
          }
          const float ig = sigmoid_f(gate[0]);
          const float fg = sigmoid_f(gate[1]);
          const float gg = tanhf(gate[2]);
          const float og = sigmoid_f(gate[3]);
          const float c_new = fg * c_prev + ig * gg;
          const float h_new = og * tanhf(c_new);
          c_state[bu] = c_new;
          h_next[bu] = __float2bfloat16(h_new);
          const size_t o = (size_t)t * bh + bu;
          put(ys + o, h_new);
          if (cs != nullptr) cs[o] = __float2bfloat16(c_new);
          if (gs != nullptr) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              gs[row + (size_t)g * hidden + u0 + cj] =
                  __float2bfloat16(gate[g]);
          }
        }
        __syncthreads();
      }
    }
    grid.sync();
  }
}

// red (kparts x kRows x ncols, kparts*ncols = 2*kThreads) + h_s
size_t bilstm_smem_bytes(int hidden) {
  return sizeof(float) * ((size_t)2 * kThreads * kRows +
                          (size_t)kRows * hidden);
}

template <typename T>
int launch(const void* xg_f, const void* xg_b, const void* wp_f,
           const void* wp_b, void* ys_f, void* ys_b, void* cs_f, void* cs_b,
           void* gs_f, void* gs_b, void* hbuf, void* cbuf, int n_steps,
           int batch, int hidden, int ut, cudaStream_t stream) {
  auto kernel = bilstm_fwd_kernel<T>;
  const size_t smem = bilstm_smem_bytes(hidden);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
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
  const int n_tiles = 2 * (hidden / ut);
  const int grid = n_tiles < per_sm * n_sm ? n_tiles : per_sm * n_sm;

  const T* a0 = static_cast<const T*>(xg_f);
  const T* a1 = static_cast<const T*>(xg_b);
  const __nv_bfloat16* a2 = static_cast<const __nv_bfloat16*>(wp_f);
  const __nv_bfloat16* a3 = static_cast<const __nv_bfloat16*>(wp_b);
  T* a4 = static_cast<T*>(ys_f);
  T* a5 = static_cast<T*>(ys_b);
  __nv_bfloat16* a6 = static_cast<__nv_bfloat16*>(cs_f);
  __nv_bfloat16* a7 = static_cast<__nv_bfloat16*>(cs_b);
  __nv_bfloat16* a8 = static_cast<__nv_bfloat16*>(gs_f);
  __nv_bfloat16* a9 = static_cast<__nv_bfloat16*>(gs_b);
  __nv_bfloat16* a10 = static_cast<__nv_bfloat16*>(hbuf);
  float* a11 = static_cast<float*>(cbuf);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &a8, &a9,
                  &a10, &a11, &n_steps, &batch, &hidden, &ut};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success). xg_bf16 selects the dtype of
// xg_* and ys_* (1: bf16, 0: f32). `ut` (1, 2, 4 or 8) must divide
// `hidden`. Null cs_*/gs_* pointers skip the stash stores. All pointers come
// from fresh PyTorch allocations (256-byte aligned).
extern "C" int bilstm_fwd(const void* xg_f, const void* xg_b,
                          const void* wp_f, const void* wp_b, void* ys_f,
                          void* ys_b, void* cs_f, void* cs_b, void* gs_f,
                          void* gs_b, void* hbuf, void* cbuf, int n_steps,
                          int batch, int hidden, int ut, int xg_bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xg_bf16)
    return launch<__nv_bfloat16>(xg_f, xg_b, wp_f, wp_b, ys_f, ys_b, cs_f,
                                 cs_b, gs_f, gs_b, hbuf, cbuf, n_steps, batch,
                                 hidden, ut, st);
  return launch<float>(xg_f, xg_b, wp_f, wp_b, ys_f, ys_b, cs_f, cs_b, gs_f,
                       gs_b, hbuf, cbuf, n_steps, batch, hidden, ut, st);
}
