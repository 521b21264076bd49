// Direction-packed bidirectional LSTM backward recurrence for Hopper
// (sm_90a), in two forms.
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
// Common design. ONE persistent cooperative launch per layer walks both
// directions, a grid barrier per step, and each block owns hidden units of
// one direction for the whole walk, so each unit's dc carry is read and
// written only by its owner. The recurrent product for a block's units needs
// their rows of w_h (contiguous in the (H,4H) layout: no packing) against
// ALL 4H columns of the previous step's dgates for all B rows. Those dgates
// are exactly the bf16 dxg rows written at the previous step, so dxg itself
// is the exchange buffer, read through L2 (never a stale L1 line).
//
// Bound on the H100. The listener runs this at a small batch (16 rows) over
// T = 400: 2*B*H*4H operations a step are nothing to the card, so the time
// is T times the latency of one step's chain: dgates rows from L2 -> product
// -> reduction -> cell update -> grid barrier. What a step must not do is
// move w_h (26.2 MB for both directions at H = 1280) or run the product on
// scalar units.
//
// bilstm_bwd_resident_kernel, the form the flagship takes (H <= 1280 on an
// H100; the same limits as the forward's resident form, ops/kernels/
// bilstm.py `form_for`). A block owns 20 units: its 20 rows of w_h (a 20 x
// (4H+8) bf16 slab, 205 KB at H = 1280) stay in shared memory for the whole
// walk, 2 * H/20 = 128 blocks at H = 1280, all co-resident on 132 SMs (16
// units a block would make 160). The previous step's dxg rows stream from L2
// through a 3-deep cp.async ring of 256-wide segments (all that fits beside
// the slab: 230,464 of the 232,448 bytes a block may have), and the product
// runs on the tensor cores (mma.sync m16n8k16 bf16, ldmatrix, f32 sums): the
// batch's one m16 tile against the slab as three n8 tiles, split over k
// across the eight warps (warp w takes the k16 steps w, w+8, ...). The third
// n-tile holds units 16-19; its last four columns repeat row 19 of the slab
// and are read by no thread (20 is not a multiple of 8, and a row beyond the
// slab lies beyond the block's shared memory). The eight partial tiles are
// written over the ring and summed by the thread that owns the cell.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, T=400 B=16 H=1280 bf16:
// ~6.0 ms (15 us a step of both directions) against 37.6 ms for the
// streamed form below and 12.7 ms for cuDNN's bidirectional LSTM backward
// alone in the same run (chip_smoke.py; PERF.md has the table).
//
// bilstm_bwd_kernel, the streamed form, for an H whose slab does not fit a
// block's shared memory or whose tiles outnumber the SMs: a block owning 1-8
// units of one direction re-reads its rows of w_h from L2 every step, stages
// the previous dxg rows in chunks of 8 batch rows, and each warp reduces one
// unit's row against them on scalar FMAs (bf16x2 loads, a shuffle
// reduction). It takes any H.
//
// Plain C interface, loaded with ctypes (see ops/kernels/bilstm.py).

#include "gru_common.cuh"

namespace {

using namespace rec;

// ---- the streamed form ----------------------------------------------------
constexpr int kStreamRows = 8;  // batch rows per chunk

// g_*:  gate stashes (T, B, 4H) bf16; cs_*: cell stashes (T, B, H) bf16.
// wh_*: w_h (H, 4H) bf16, the JAX layout (row u holds unit u's 4H columns).
// dy_*: (T, B, H) in the stream dtype. dxg_*: (T, B, 4H) bf16 outputs.
// dcbuf: (2 directions, B, H) f32, zeroed by the caller.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_bwd_kernel(const bf16* __restrict__ g_f, const bf16* __restrict__ g_b,
                  const bf16* __restrict__ wh_f,
                  const bf16* __restrict__ wh_b,
                  const bf16* __restrict__ cs_f,
                  const bf16* __restrict__ cs_b,
                  const T* __restrict__ dy_f, const T* __restrict__ dy_b,
                  bf16* dxg_f, bf16* dxg_b, float* dcbuf, int n_steps,
                  int batch, int hidden, int ut) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int kparts = kWarps / ut;      // warps sharing one unit's k axis
  const int npairs = 2 * hidden;       // bf16 pairs in a 4H row
  float* red = smem;                   // (kparts, kStreamRows, ut)
  __nv_bfloat162* dg_s = reinterpret_cast<__nv_bfloat162*>(
      smem + kparts * kStreamRows * ut);  // (kStreamRows, 4H) bf16
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
      const bf16* gs = dir == 0 ? g_f : g_b;
      const bf16* cs = dir == 0 ? cs_f : cs_b;
      const bf16* wh = dir == 0 ? wh_f : wh_b;
      const T* dy = dir == 0 ? dy_f : dy_b;
      bf16* dxg = dir == 0 ? dxg_f : dxg_b;
      float* dc_state = dcbuf + (size_t)dir * bh;

      for (int r0 = 0; r0 < batch; r0 += kStreamRows) {
        const int nr = min(kStreamRows, batch - r0);
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
          const bf16* src = dxg + ((size_t)t_prev * batch + r0) * h4;
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
          float acc[kStreamRows];
#pragma unroll
          for (int r = 0; r < kStreamRows; ++r) acc[r] = 0.0f;
          const __nv_bfloat162* wrow = reinterpret_cast<const __nv_bfloat162*>(
              wh + (size_t)(u0 + wj) * h4);
#pragma unroll 4
          for (int p = wk * 32 + lane; p < npairs; p += kparts * 32) {
            const float2 wv = __bfloat1622float2(wrow[p]);
#pragma unroll
            for (int r = 0; r < kStreamRows; ++r) {
              if (r < nr) {
                const float2 dv = __bfloat1622float2(dg_s[r * npairs + p]);
                acc[r] = fmaf(dv.x, wv.x, acc[r]);
                acc[r] = fmaf(dv.y, wv.y, acc[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kStreamRows; ++r) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
          }
          if (lane == 0) {
#pragma unroll
            for (int r = 0; r < kStreamRows; ++r)
              red[(wk * kStreamRows + r) * ut + wj] = acc[r];
          }
          __syncthreads();
        }

        if (cell) {
          float dh = dy_v;
          if (s > 0) {
            float rec = 0.0f;
            for (int p = 0; p < kparts; ++p)
              rec += red[(p * kStreamRows + cr) * ut + cj];
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

size_t streamed_smem_bytes(int hidden, int ut) {
  const int kparts = kWarps / ut;
  return sizeof(float) * (size_t)kparts * kStreamRows * ut +
         sizeof(bf16) * (size_t)kStreamRows * 4 * hidden;
}

template <typename T>
int launch_streamed(const void* g_f, const void* g_b, const void* wh_f,
                    const void* wh_b, const void* cs_f, const void* cs_b,
                    const void* dy_f, const void* dy_b, void* dxg_f,
                    void* dxg_b, void* dcbuf, int n_steps, int batch,
                    int hidden, int ut, cudaStream_t stream) {
  void* args[] = {&g_f,  &g_b,   &wh_f,  &wh_b,    &cs_f,  &cs_b,
                  &dy_f, &dy_b,  &dxg_f, &dxg_b,   &dcbuf, &n_steps,
                  &batch, &hidden, &ut};
  return coop_launch((const void*)bilstm_bwd_kernel<T>,
                     streamed_smem_bytes(hidden, ut), 2 * (hidden / ut),
                     false, args, stream);
}

// ---- the resident form ----------------------------------------------------
constexpr int kResUnits = 20;
constexpr int kResNT = 3;  // n8 tiles over the 20 units (4 columns unread)
constexpr int kResCols = 8 * kResNT;
constexpr int kResRing = 3;
constexpr int kResRingElems = kResRing * kRows * kLda;
static_assert(sizeof(bf16) * kResRingElems >=
                  sizeof(float) * kWarps * kRows * kResCols,
              "the partial tiles overlay the ring");

inline size_t resident_smem_bytes(int hidden) {
  return sizeof(bf16) *
         ((size_t)kResUnits * (4 * hidden + 8) + kResRingElems);
}

// part[w][row][0..24) = warp w's partial product over its k16 steps (w,
// w+8, ... of each segment) of
//     A[rows, K] * Wt[24, K]^T      (A bf16 in global, Wt the slab in shared)
// for one pass of up to kRows rows, where rows 20..23 of Wt repeat row 19.
// The partials are written over the ring once every warp has read its last
// segment, and are visible to every thread on return.
__device__ __forceinline__ void resident_product(const bf16* a_g, size_t lda,
                                                 int nrows, int K,
                                                 const bf16* w_res, int ldw,
                                                 bf16* ring, float* part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc[kResNT][4];
#pragma unroll
  for (int n = 0; n < kResNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // B fragments: n-tiles 0 and 1 in one ldmatrix_x4 (lane l addresses row
  // l%8 of n-tile l/16, k half (l/8)%2), n-tile 2 in an ldmatrix_x2 (lanes
  // 0-15 address rows 16 + l%8, clamped to the slab's last row)
  const int khalf = ((lane >> 3) & 1) * 8;
  const bf16* w01 = w_res + (size_t)((lane >> 4) * 8 + (lane & 7)) * ldw + khalf;
  const bf16* w2 =
      w_res + (size_t)min(16 + (lane & 7), kResUnits - 1) * ldw + khalf;

  const int nseg = (K + kSeg - 1) / kSeg;
  auto fetch = [&](int c) {
    const int k0 = c * kSeg;
    const int ppr = min(kSeg, K - k0) >> 3;  // 16-byte pieces per row
    bf16* dst = ring + (c % kResRing) * kRows * kLda;
    for (int i = threadIdx.x; i < nrows * ppr; i += kThreads) {
      const int r = i / ppr;
      const int p = i - r * ppr;
      cp_async16(dst + r * kLda + p * 8, a_g + (size_t)r * lda + k0 + p * 8);
    }
  };
  for (int c = 0; c < kResRing - 1; ++c) {
    if (c < nseg) fetch(c);
    cp_async_commit();
  }
  for (int c = 0; c < nseg; ++c) {
    cp_async_wait<kResRing - 2>();
    __syncthreads();  // segment c landed for all, segment c-1's buffer free
    if (c + kResRing - 1 < nseg) fetch(c + kResRing - 1);
    cp_async_commit();
    const int k0 = c * kSeg;
    const int ksteps = min(kSeg, K - k0) >> 4;
    const bf16* a_st = ring + (c % kResRing) * kRows * kLda;
    for (int ks = warp; ks < ksteps; ks += kWarps) {
      const int kk = ks * 16;
      uint32_t a[4];  // lane l addresses row l%16, k half l/16
      ldmatrix_x4(a, a_st + (lane & 15) * kLda + kk + (lane >> 4) * 8);
      uint32_t b[4], b2[2];
      ldmatrix_x4(b, w01 + k0 + kk);
      ldmatrix_x2(b2, w2 + k0 + kk);
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
      mma_bf16(acc[2], a, b2[0], b2[1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp has read the ring: it becomes the partials
  // element e of n-tile n is (row lane/4 + 8*(e/2), col 8n + 2*(lane%4) + e%2)
  float* mine = part + (size_t)warp * kRows * kResCols;
#pragma unroll
  for (int n = 0; n < kResNT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (lane >> 2) + 8 * half;
      *reinterpret_cast<float2*>(mine + row * kResCols + n * 8 +
                                 2 * (lane & 3)) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
  __syncthreads();
}

// Blocks 0 .. H/20 - 1 walk the forward direction, the others the backward
// one. wh_*: w_h (H, 4H) bf16 as it is. dcbuf (2, B, H) f32 zeroed. `hidden`
// is a multiple of 20.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_bwd_resident_kernel(const bf16* __restrict__ g_f,
                           const bf16* __restrict__ g_b,
                           const bf16* __restrict__ wh_f,
                           const bf16* __restrict__ wh_b,
                           const bf16* __restrict__ cs_f,
                           const bf16* __restrict__ cs_b,
                           const T* __restrict__ dy_f,
                           const T* __restrict__ dy_b, bf16* dxg_f,
                           bf16* dxg_b, float* dcbuf, int n_steps, int batch,
                           int hidden) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char resident_smem[];
  bf16* w_res = reinterpret_cast<bf16*>(resident_smem);
  const int k_all = 4 * hidden;
  const int ldw = k_all + 8;
  bf16* ring = w_res + (size_t)kResUnits * ldw;
  float* part = reinterpret_cast<float*>(ring);
  const int tiles_per_dir = hidden / kResUnits;
  const int dir = blockIdx.x / tiles_per_dir;
  const int u0 = (blockIdx.x % tiles_per_dir) * kResUnits;
  const size_t bh = (size_t)batch * hidden;
  const size_t h4 = (size_t)k_all;
  const bf16* gs = dir ? g_b : g_f;
  const bf16* cs = dir ? cs_b : cs_f;
  const T* dy = dir ? dy_b : dy_f;
  bf16* dxg = dir ? dxg_b : dxg_f;
  float* dc_state = dcbuf + (size_t)dir * bh;
  // the thread's cells of a 16-row pass: (tid / 16, tid % 16) and, for the
  // first 64 threads, (tid / 4, 16 + tid % 4): 320 cells on 256 threads
  const int tid = threadIdx.x;
  const int n_mine = tid < 64 ? 2 : 1;
  const int rows[2] = {tid >> 4, tid >> 2};
  const int units[2] = {tid & 15, 16 + (tid & 3)};

  for (int i = tid; i < kResRingElems; i += kThreads)
    ring[i] = __float2bfloat16(0.0f);
  load_resident(w_res, (dir ? wh_b : wh_f) + (size_t)u0 * h4, h4, kResUnits,
                k_all);

  for (int s = 0; s < n_steps; ++s) {
    // the forward direction walks data T-1..0, the backward one 0..T-1
    const int t = dir ? s : n_steps - 1 - s;
    const int t_prev = dir ? t - 1 : t + 1;  // visited at step s-1
    const int t_cp = dir ? t + 1 : t - 1;    // forward-scan predecessor
    const bool has_cp = t_cp >= 0 && t_cp < n_steps;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int nr = min(kRows, batch - r0);
      // the cells' global loads start ahead of the product
      float gate[2][4], c_t[2], c_prev[2], dy_v[2], dc[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool live = q < n_mine && rows[q] < nr;
        const size_t grow =
            ((size_t)t * batch + r0 + rows[q]) * h4 + u0 + units[q];
        const size_t bu = (size_t)(r0 + rows[q]) * hidden + u0 + units[q];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gate[q][g] =
              live ? __bfloat162float(gs[grow + (size_t)g * hidden]) : 0.0f;
        c_t[q] = live ? __bfloat162float(cs[(size_t)t * bh + bu]) : 0.0f;
        c_prev[q] = live && has_cp
                        ? __bfloat162float(cs[(size_t)t_cp * bh + bu])
                        : 0.0f;
        dy_v[q] = live ? to_f(dy[(size_t)t * bh + bu]) : 0.0f;
        dc[q] = live ? dc_state[bu] : 0.0f;
      }
      if (s > 0)
        resident_product(dxg + ((size_t)t_prev * batch + r0) * h4, h4, nr,
                         k_all, w_res, ldw, ring, part);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= n_mine || rows[q] >= nr) continue;
        float dh = dy_v[q];
        if (s > 0) {
          float rec = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            rec += part[((size_t)w * kRows + rows[q]) * kResCols + units[q]];
          dh += rec;
        }
        const float ig = sigmoid_f(gate[q][0]);
        const float fg = sigmoid_f(gate[q][1]);
        const float gg = tanhf(gate[q][2]);
        const float og = sigmoid_f(gate[q][3]);
        const float tc = tanhf(c_t[q]);
        const float d_o = dh * tc;
        const float dct = dc[q] + dh * og * (1.0f - tc * tc);
        const float dg[4] = {dct * gg * ig * (1.0f - ig),
                             dct * c_prev[q] * fg * (1.0f - fg),
                             dct * ig * (1.0f - gg * gg),
                             d_o * og * (1.0f - og)};
        const size_t grow =
            ((size_t)t * batch + r0 + rows[q]) * h4 + u0 + units[q];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          dxg[grow + (size_t)g * hidden] = __float2bfloat16(dg[g]);
        dc_state[(size_t)(r0 + rows[q]) * hidden + u0 + units[q]] = dct * fg;
      }
      __syncthreads();  // the partials become the ring again
    }
    grid.sync();
  }
}

template <typename T>
int launch_resident(const void* g_f, const void* g_b, const void* wh_f,
                    const void* wh_b, const void* cs_f, const void* cs_b,
                    const void* dy_f, const void* dy_b, void* dxg_f,
                    void* dxg_b, void* dcbuf, int n_steps, int batch,
                    int hidden, cudaStream_t stream) {
  void* args[] = {&g_f,  &g_b,  &wh_f,  &wh_b,  &cs_f,    &cs_b,  &dy_f,
                  &dy_b, &dxg_f, &dxg_b, &dcbuf, &n_steps, &batch, &hidden};
  return coop_launch((const void*)bilstm_bwd_resident_kernel<T>,
                     resident_smem_bytes(hidden), 2 * (hidden / kResUnits),
                     true, args, stream);
}

}  // namespace

// Both return a cudaError_t code (0 on success). dy_bf16 selects the dtype
// of dy_* (1: bf16, 0: f32); every other operand is bf16 except dcbuf (2
// directions, B, H) f32, zeroed. All pointers come from fresh or contiguous
// PyTorch tensors (16-byte aligned rows when hidden is even).
//
// bilstm_bwd_resident: `hidden` a multiple of 20 (the wrapper pads to 80,
// as the forward's resident form); refused when the card cannot hold the
// 2 * hidden/20 blocks co-resident.
extern "C" int bilstm_bwd_resident(const void* g_f, const void* g_b,
                                   const void* wh_f, const void* wh_b,
                                   const void* cs_f, const void* cs_b,
                                   const void* dy_f, const void* dy_b,
                                   void* dxg_f, void* dxg_b, void* dcbuf,
                                   int n_steps, int batch, int hidden,
                                   int dy_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden < kResUnits || hidden % kResUnits != 0 || n_steps < 1 ||
      batch < 1)
    return (int)cudaErrorInvalidValue;
  if (dy_bf16)
    return launch_resident<bf16>(g_f, g_b, wh_f, wh_b, cs_f, cs_b, dy_f, dy_b,
                                 dxg_f, dxg_b, dcbuf, n_steps, batch, hidden,
                                 st);
  return launch_resident<float>(g_f, g_b, wh_f, wh_b, cs_f, cs_b, dy_f, dy_b,
                                dxg_f, dxg_b, dcbuf, n_steps, batch, hidden,
                                st);
}

// bilstm_bwd: the streamed form; `ut` (1, 2, 4 or 8) must divide `hidden`.
extern "C" int bilstm_bwd(const void* g_f, const void* g_b, const void* wh_f,
                          const void* wh_b, const void* cs_f,
                          const void* cs_b, const void* dy_f,
                          const void* dy_b, void* dxg_f, void* dxg_b,
                          void* dcbuf, int n_steps, int batch, int hidden,
                          int ut, int dy_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ut != 1 && ut != 2 && ut != 4 && ut != 8) || hidden % ut != 0 ||
      n_steps < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  if (dy_bf16)
    return launch_streamed<bf16>(g_f, g_b, wh_f, wh_b, cs_f, cs_b, dy_f, dy_b,
                                 dxg_f, dxg_b, dcbuf, n_steps, batch, hidden,
                                 ut, st);
  return launch_streamed<float>(g_f, g_b, wh_f, wh_b, cs_f, cs_b, dy_f, dy_b,
                                dxg_f, dxg_b, dcbuf, n_steps, batch, hidden,
                                ut, st);
}
