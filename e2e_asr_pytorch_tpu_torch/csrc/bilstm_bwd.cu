// Direction-packed bidirectional LSTM backward recurrence for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_bi_bwd_kernel` / `_bilstm_bwd_pallas`
// (e2e_asr_pytorch_tpu/ops/pallas/lstm.py). One launch walks BOTH
// directions of one encoder layer backwards over the whole sequence from the
// forward kernel's bf16 stashes (cell states cs, gate pre-activations gates):
// at loop step s the forward direction visits data index T-1-s and the
// backward direction data index s. Per direction and step
//
//     i, f, g, o   = act(gates[t])                    (f32 from the stash)
//     dh           = dy[t] + bf16(dgates_prev) @ bf16(w_h)^T   (f32 acc.)
//     do           = dh * tanh(c[t])
//     dc           = dc_carry + dh * o * (1 - tanh(c[t])^2)
//     dgates       = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2),
//                     do*o*(1-o)]
//     dxg[t]       = bf16(dgates) ;  dc_carry = dc * f
//
// where dgates_prev is the previous backward step's, i.e. dxg at the data
// index visited one loop step earlier, and c_prev is the cell state that the
// forward scan saw before t (zero at the scan's start). dW_h is one matmul
// outside the kernel (ops/kernels/bilstm.py).
//
// Design. As the forward kernel (bilstm_fwd.cu): ONE persistent cooperative
// launch per layer, a grid-wide barrier per step, and each block owns a tile
// of `ut` hidden units of one direction for the whole walk, so each unit's
// dc carry is read and written only by its owner. The recurrent product for
// a tile needs the block's own `ut` rows of w_h (contiguous in the (H,4H)
// layout) against ALL 4H columns of the previous step's dgates for all B
// rows. Those dgates are exactly the bf16 dxg rows written at the previous
// step, so dxg itself is the exchange buffer: a block stages the previous
// dxg rows (read through L2 with ld.global.cg, never a stale L1 line) into
// shared memory in chunks of kRows batch rows, then each warp reduces one
// unit's row of w_h against them (bf16x2 loads, f32 FMAs, a warp shuffle
// reduction). B=16, the flagship batch, runs as two row chunks.
//
// Bound on the H100. Per step every block reads its w_h rows (both
// directions together 26.2 MB bf16 at H=1280, held in the 50 MB L2) once per
// row chunk, plus the previous dgates (B x 4H bf16 per direction) once per
// block: about 2 x 26 MB + 40 MB of L2 reads per step at B=16, then one grid
// barrier, and T steps run strictly in sequence. w_h resident in shared
// memory, wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes (see ops/kernels/bilstm.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads per block (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;       // batch rows per chunk

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// g_*:  gate stashes (T, B, 4H) bf16; cs_*: cell stashes (T, B, H) bf16.
// wh_*: w_h (H, 4H) bf16, the JAX layout (row u holds unit u's 4H columns).
// dy_*: (T, B, H) in the stream dtype. dxg_*: (T, B, 4H) bf16 outputs.
// dcbuf: (2 directions, B, H) f32, zeroed by the caller.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_bwd_kernel(const __nv_bfloat16* __restrict__ g_f,
                  const __nv_bfloat16* __restrict__ g_b,
                  const __nv_bfloat16* __restrict__ wh_f,
                  const __nv_bfloat16* __restrict__ wh_b,
                  const __nv_bfloat16* __restrict__ cs_f,
                  const __nv_bfloat16* __restrict__ cs_b,
                  const T* __restrict__ dy_f, const T* __restrict__ dy_b,
                  __nv_bfloat16* dxg_f, __nv_bfloat16* dxg_b, float* dcbuf,
                  int n_steps, int batch, int hidden, int ut) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int kparts = kWarps / ut;      // warps sharing one unit's k axis
  const int npairs = 2 * hidden;       // bf16 pairs in a 4H row
  float* red = smem;                   // (kparts, kRows, ut)
  __nv_bfloat162* dg_s = reinterpret_cast<__nv_bfloat162*>(
      smem + kparts * kRows * ut);     // (kRows, 4H) bf16
  const int tiles_per_dir = hidden / ut;
  const int n_tiles = 2 * tiles_per_dir;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wj = warp % ut;            // this warp's unit within the tile
  const int wk = warp / ut;            // and its part of the k axis
  const size_t bh = (size_t)batch * hidden;
  const size_t h4 = (size_t)4 * hidden;
  const bool vec_stage = (hidden % 2) == 0;  // 4H*2 bytes % 16 == 0

  for (int s = 0; s < n_steps; ++s) {
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int dir = tile / tiles_per_dir;
      const int tl = tile % tiles_per_dir;
      const int u0 = tl * ut;
      // forward direction walks data T-1..0, backward direction 0..T-1
      const int t = dir == 0 ? n_steps - 1 - s : s;
      const int t_prev = dir == 0 ? t + 1 : t - 1;  // visited at step s-1
      const int t_cp = dir == 0 ? t - 1 : t + 1;    // forward-scan predecessor
      const bool has_cp = t_cp >= 0 && t_cp < n_steps;
      const __nv_bfloat16* gs = dir == 0 ? g_f : g_b;
      const __nv_bfloat16* cs = dir == 0 ? cs_f : cs_b;
      const __nv_bfloat16* wh = dir == 0 ? wh_f : wh_b;
      const T* dy = dir == 0 ? dy_f : dy_b;
      __nv_bfloat16* dxg = dir == 0 ? dxg_f : dxg_b;
      float* dc_state = dcbuf + (size_t)dir * bh;

      for (int r0 = 0; r0 < batch; r0 += kRows) {
        const int nr = min(kRows, batch - r0);
        // one thread per (row, unit) cell of the chunk: start its global
        // loads (stashes, dy, dc) ahead of the recurrent product
        const bool cell = tid < nr * ut;
        const int cr = cell ? tid / ut : 0;
        const int cj = cell ? tid % ut : 0;
        const size_t grow = ((size_t)t * batch + r0 + cr) * h4;
        const size_t bu = (size_t)(r0 + cr) * hidden + u0 + cj;
        float gate[4];
        float c_t = 0.0f, c_prev = 0.0f, dy_v = 0.0f, dc = 0.0f;
        if (cell) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gate[g] = __bfloat162float(gs[grow + (size_t)g * hidden + u0 + cj]);
          c_t = __bfloat162float(cs[(size_t)t * bh + bu]);
          if (has_cp) c_prev = __bfloat162float(cs[(size_t)t_cp * bh + bu]);
          dy_v = to_f(dy[(size_t)t * bh + bu]);
          dc = dc_state[bu];
        }

        if (s > 0) {
          // stage the previous step's bf16 dgates rows (written by other
          // blocks before the last barrier: read through L2)
          const __nv_bfloat16* src = dxg + ((size_t)t_prev * batch + r0) * h4;
          const size_t n_stage = (size_t)nr * h4;
          if (vec_stage) {
            const uint4* src16 = reinterpret_cast<const uint4*>(src);
            uint4* dst16 = reinterpret_cast<uint4*>(dg_s);
            for (size_t i = tid; i < n_stage / 8; i += kThreads)
              dst16[i] = __ldcg(src16 + i);
          } else {
            const unsigned short* src1 =
                reinterpret_cast<const unsigned short*>(src);
            unsigned short* dst1 = reinterpret_cast<unsigned short*>(dg_s);
            for (size_t i = tid; i < n_stage; i += kThreads)
              dst1[i] = __ldcg(src1 + i);
          }
          __syncthreads();

          // dh[r, u0+wj] partial over this warp's slice of the 4H axis
          float acc[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
          const __nv_bfloat162* wrow = reinterpret_cast<const __nv_bfloat162*>(
              wh + (size_t)(u0 + wj) * h4);
#pragma unroll 4
          for (int p = wk * 32 + lane; p < npairs; p += kparts * 32) {
            const float2 wv = __bfloat1622float2(wrow[p]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < nr) {
                const float2 dv = __bfloat1622float2(dg_s[r * npairs + p]);
                acc[r] = fmaf(dv.x, wv.x, acc[r]);
                acc[r] = fmaf(dv.y, wv.y, acc[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
          }
          if (lane == 0) {
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              red[(wk * kRows + r) * ut + wj] = acc[r];
          }
          __syncthreads();
        }

        if (cell) {
          float dh = dy_v;
          if (s > 0) {
            float rec = 0.0f;
            for (int p = 0; p < kparts; ++p)
              rec += red[(p * kRows + cr) * ut + cj];
            dh += rec;
          }
          const float ig = sigmoid_f(gate[0]);
          const float fg = sigmoid_f(gate[1]);
          const float gg = tanhf(gate[2]);
          const float og = sigmoid_f(gate[3]);
          const float tc = tanhf(c_t);
          const float d_o = dh * tc;
          const float dct = dc + dh * og * (1.0f - tc * tc);
          const float dg[4] = {dct * gg * ig * (1.0f - ig),
                               dct * c_prev * fg * (1.0f - fg),
                               dct * ig * (1.0f - gg * gg),
                               d_o * og * (1.0f - og)};
#pragma unroll
          for (int g = 0; g < 4; ++g)
            dxg[grow + (size_t)g * hidden + u0 + cj] = __float2bfloat16(dg[g]);
          dc_state[bu] = dct * fg;
        }
        __syncthreads();  // dg_s and red are reused by the next chunk
      }
    }
    grid.sync();
  }
}

size_t bilstm_bwd_smem_bytes(int hidden, int ut) {
  const int kparts = kWarps / ut;
  return sizeof(float) * (size_t)kparts * kRows * ut +
         sizeof(__nv_bfloat16) * (size_t)kRows * 4 * hidden;
}

template <typename T>
int launch(const void* g_f, const void* g_b, const void* wh_f,
           const void* wh_b, const void* cs_f, const void* cs_b,
           const void* dy_f, const void* dy_b, void* dxg_f, void* dxg_b,
           void* dcbuf, int n_steps, int batch, int hidden, int ut,
           cudaStream_t stream) {
  auto kernel = bilstm_bwd_kernel<T>;
  if (ut < 1 || ut > kWarps || kWarps % ut != 0 || hidden % ut != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bilstm_bwd_smem_bytes(hidden, ut);
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

  const __nv_bfloat16* a0 = static_cast<const __nv_bfloat16*>(g_f);
  const __nv_bfloat16* a1 = static_cast<const __nv_bfloat16*>(g_b);
  const __nv_bfloat16* a2 = static_cast<const __nv_bfloat16*>(wh_f);
  const __nv_bfloat16* a3 = static_cast<const __nv_bfloat16*>(wh_b);
  const __nv_bfloat16* a4 = static_cast<const __nv_bfloat16*>(cs_f);
  const __nv_bfloat16* a5 = static_cast<const __nv_bfloat16*>(cs_b);
  const T* a6 = static_cast<const T*>(dy_f);
  const T* a7 = static_cast<const T*>(dy_b);
  __nv_bfloat16* a8 = static_cast<__nv_bfloat16*>(dxg_f);
  __nv_bfloat16* a9 = static_cast<__nv_bfloat16*>(dxg_b);
  float* a10 = static_cast<float*>(dcbuf);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &a8, &a9,
                  &a10, &n_steps, &batch, &hidden, &ut};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success). dy_bf16 selects the dtype of
// dy_* (1: bf16, 0: f32); every other operand is bf16 except dcbuf (f32).
// `ut` (1, 2, 4 or 8) must divide `hidden`. All pointers come from fresh or
// contiguous PyTorch tensors (16-byte aligned rows when hidden is even).
extern "C" int bilstm_bwd(const void* g_f, const void* g_b, const void* wh_f,
                          const void* wh_b, const void* cs_f,
                          const void* cs_b, const void* dy_f,
                          const void* dy_b, void* dxg_f, void* dxg_b,
                          void* dcbuf, int n_steps, int batch, int hidden,
                          int ut, int dy_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dy_bf16)
    return launch<__nv_bfloat16>(g_f, g_b, wh_f, wh_b, cs_f, cs_b, dy_f, dy_b,
                                 dxg_f, dxg_b, dcbuf, n_steps, batch, hidden,
                                 ut, st);
  return launch<float>(g_f, g_b, wh_f, wh_b, cs_f, cs_b, dy_f, dy_b, dxg_f,
                       dxg_b, dcbuf, n_steps, batch, hidden, ut, st);
}
