// Bidirectional LSTM forward recurrence for Hopper (sm_90a), in two forms.
//
// Replaces the TPU kernel `_bi_fwd_kernel` / `_bilstm_fwd_pallas`
// (e2e_asr_pytorch_tpu/ops/pallas/lstm.py). One call advances BOTH
// directions of one encoder layer over the whole sequence: the forward
// direction consumes data index s at its step s and the backward direction
// data index T-1-s, each from a zero initial state. Per direction and step
//
//     gates = xg[t] + bf16(h_prev) @ bf16(w_h)      (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid  (gate order i,f,g,o)
//     c = f * c_prev + i * g ;  h = o * tanh(c)     (c and h carried in f32)
//
// ys is written in xg's dtype (f32 or bf16); the bf16 stashes of c and of the
// gate pre-activations (the inputs of the backward kernel) are written only
// when their pointers are non-null.
//
// Bound on the H100. The listener runs this at a small batch (16 or 8 rows)
// over a long sequence (T = 400): 2*B*H*4H operations and 40 KB of h a step
// are nothing to the card, so the time is T times the latency of one step's
// chain: h from L2 -> product -> reduction -> cell update -> grid barrier.
// What a step must not do is move w_h (26.2 MB for both directions at
// H = 1280) or run the product on scalar units.
//
// bilstm_resident_kernel, the form the flagship takes (H <= 1280 on an
// H100). One persistent cooperative launch of 2 * H/20 blocks walks both
// directions at once, a grid barrier per step: blocks 0 .. H/20 - 1 the
// forward direction, the others the backward one. (The TPU kernel packed the
// two directions into one matrix-unit pass to fill its systolic array; here
// they only share the launch and the barrier.) A block owns 20 hidden units
// of its direction for the whole walk: the 80 gate columns of its units stay
// in shared memory (an 80 x (H+8) bf16 slab, 206 KB at H = 1280, copied
// once), bf16(h) is exchanged between blocks through a double-buffered
// global buffer that the next step reads from L2 through a cp.async ring of
// 256-wide segments, and the product runs on the tensor cores (mma.sync
// m16n8k16 bf16, ldmatrix): the batch's one m16 tile against the slab's ten
// n-tiles, split over the eight warps four ways by k and two ways by n, the
// four partial tiles written over the ring (nothing else fits beside the
// slab: 231,424 of the 232,448 bytes a block may have) and summed by the
// thread that owns the cell (row, unit), which keeps the cell's f32 c. 20
// units a block, not the GRU family's 16, because 2 * 1280/16 = 160 blocks of
// this size do not fit the card's 132 SMs and 128 do.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, T=400 B=16 H=1280 bf16 with
// stashes: 3.84 ms (9.6 us a step of both directions), against 20.14 ms (50.3
// us a step) for the streamed form below and 14.21 ms for cuDNN's
// bidirectional LSTM with its input projection in the same run
// (chip_smoke.py; PERF.md has the table). The same design at 16 units a block
// with the directions one after the other (two launches) took 5.4 ms.
//
// The same kernel over ONE direction is K5f's narrow form (the TPU's
// `_fwd_kernel` for a batch of one m16 tile of rows: the single-direction
// listener; ops/kernels/lstm.py): the launch names its first direction (0:
// t = s, 1: t = T-1-s, K5f's `reverse`) and its count, and a block owns 10
// units, 128 blocks at H = 1280: at T=400 B=16 H=1280 bf16 2.53-2.60 ms (6.4
// us a step) against 5.69-6.26 ms for the kernel it replaced
// (script/torch_k5_time.py); 20 units a block, and a deeper ring, measured
// slower (script/torch_k5_forms.py; PERF.md).
//
// bilstm_fwd_kernel, the streamed form, for an H whose slab does not fit a
// block's shared memory or whose tiles outnumber the SMs (the wrapper's rule,
// ops/kernels/bilstm.py `form_for`): one cooperative launch for both
// directions, a block owning 8 units of one direction, w_h re-read from L2
// every step (packed per tile so each row of a slab is one coalesced read)
// and the product on scalar FMAs over f32 copies of h. It takes any H.
// Later work: a tensor-core streamed form.
//
// Plain C interface, loaded with ctypes (see ops/kernels/bilstm.py).

#include "gru_common.cuh"

namespace {

using namespace rec;

constexpr int kStreamRows = 8;  // streamed form: batch rows per pass
constexpr int kUnroll = 8;      // streamed form: h steps whose loads overlap

// wp_*: packed w_h, (H/ut, H, 4, ut) bf16 -- tile-major slabs of the 4*ut
//       gate columns a tile owns (column g*H + u0 + j sits at g*ut + j).
// hbuf: (2 directions, 2 buffers, B, H) bf16, buffer 0 zeroed by the caller.
// cbuf: (2 directions, B, H) f32, zeroed by the caller.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_fwd_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                  const bf16* __restrict__ wp_f,
                  const bf16* __restrict__ wp_b, T* ys_f, T* ys_b,
                  bf16* cs_f, bf16* cs_b,
                  bf16* gs_f, bf16* gs_b,
                  bf16* hbuf, float* cbuf, int n_steps, int batch,
                  int hidden, int ut) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  // each thread owns a PAIR of adjacent gate columns of the tile (one 4-byte
  // bf16x2 load per h index) and a strided slice of the h axis
  const int ncols = 4 * ut;
  const int npairs = ncols / 2;
  const int kparts = kThreads / npairs;
  float* red = smem;  // (kparts, kStreamRows, ncols)
  // (kStreamRows, hidden), bf16 values
  float* h_s = smem + kparts * kStreamRows * ncols;
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
      bf16* cs = dir == 0 ? cs_f : cs_b;
      bf16* gs = dir == 0 ? gs_f : gs_b;
      const __nv_bfloat162* w = reinterpret_cast<const __nv_bfloat162*>(
          (dir == 0 ? wp_f : wp_b) + (size_t)tl * hidden * ncols);
      const bf16* h_prev = hbuf + ((size_t)dir * 2 + rd) * bh;
      bf16* h_next = hbuf + ((size_t)dir * 2 + (rd ^ 1)) * bh;
      float* c_state = cbuf + (size_t)dir * bh;

      for (int r0 = 0; r0 < batch; r0 += kStreamRows) {
        const int nr = min(kStreamRows, batch - r0);
        // The chunk has nr*ut <= kStreamRows*8 = 64 cells, one per thread:
        // issue the cell's global loads (xg gates, c) now, ahead of the
        // matmul.
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
        const bf16* src = h_prev + (size_t)r0 * hidden;
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

        float acc0[kStreamRows], acc1[kStreamRows];
#pragma unroll
        for (int r = 0; r < kStreamRows; ++r) acc0[r] = acc1[r] = 0.0f;
        // partial dot products over this thread's slice of the h axis
#pragma unroll kUnroll
        for (int k = kp; k < hidden; k += kparts) {
          const float2 wv = __bfloat1622float2(w[(size_t)k * npairs + pair]);
#pragma unroll
          for (int r = 0; r < kStreamRows; ++r) {
            if (r < nr) {
              const float hv = h_s[(size_t)r * hidden + k];
              acc0[r] = fmaf(hv, wv.x, acc0[r]);
              acc1[r] = fmaf(hv, wv.y, acc1[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kStreamRows; ++r) {
          float* dst = red + (kp * kStreamRows + r) * ncols + 2 * pair;
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
              sum += red[(p * kStreamRows + cr) * ncols + cc];
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

// red (kparts x kStreamRows x ncols, kparts*ncols = 2*kThreads) + h_s
size_t streamed_smem_bytes(int hidden) {
  return sizeof(float) * ((size_t)2 * kThreads * kStreamRows +
                          (size_t)kStreamRows * hidden);
}

template <typename T>
int launch_streamed(const void* xg_f, const void* xg_b, const void* wp_f,
                    const void* wp_b, void* ys_f, void* ys_b, void* cs_f,
                    void* cs_b, void* gs_f, void* gs_b, void* hbuf, void* cbuf,
                    int n_steps, int batch, int hidden, int ut,
                    cudaStream_t stream) {
  void* args[] = {&xg_f, &xg_b, &wp_f, &wp_b, &ys_f, &ys_b, &cs_f, &cs_b,
                  &gs_f, &gs_b, &hbuf, &cbuf, &n_steps, &batch, &hidden, &ut};
  return coop_launch((const void*)bilstm_fwd_kernel<T>,
                     streamed_smem_bytes(hidden), 2 * (hidden / ut), false,
                     args, stream);
}

// ---- the resident form ----------------------------------------------------
// A block owns U units of one direction: U = 20 when both directions share
// the launch (K1), U = 10 for one direction alone (K5f's narrow form,
// ops/kernels/lstm.py), which measured faster than 20 there (PERF.md).
constexpr int kResRing = 3;
constexpr int kResRingElems = kResRing * kRows * kLda;

template <int U>
struct ResTile {
  static constexpr int kCols = 4 * U;         // gate columns: 5 n-tiles a warp
  static constexpr int kNSplit = kCols / 40;  // warps sharing a k group
  static constexpr int kKGroups = kWarps / kNSplit;
  static_assert(kNSplit == 1 || kNSplit == 2, "five n-tiles a warp");
  static_assert(sizeof(bf16) * kResRingElems >=
                    sizeof(float) * kKGroups * kRows * kCols,
                "the partial tiles overlay the ring");
};

template <int U>
inline size_t resident_smem_bytes(int hidden) {
  return sizeof(bf16) *
         ((size_t)ResTile<U>::kCols * (hidden + 8) + kResRingElems);
}

// part[g][row][0..4U) = the partial product of k group g of
//     A[rows, K] * Wt[4U, K]^T           (A bf16 in global, Wt in shared)
// for one pass of up to kRows rows: warp w takes k group w / kNSplit and
// the five n-tiles 5 (w % kNSplit) .. 5 (w % kNSplit) + 4 (U = 20: k groups
// of two warps; U = 10: a k group a warp). The partials are written over the
// ring once every warp has read its last segment.
template <int U>
__device__ __forceinline__ void resident_product(const bf16* a_g, size_t lda,
                                               int nrows, int K,
                                               const bf16* w_res, int ldw,
                                               bf16* ring, float* part) {
  using R = ResTile<U>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // shift and mask, not division: the compiler then bounds the k loop's
  // trip count and unrolls it (measured: a division cost K1 17%)
  const int kg = warp >> (R::kNSplit - 1);
  const int n0 = (warp & (R::kNSplit - 1)) * 5;
  float acc[5][4];
#pragma unroll
  for (int n = 0; n < 5; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

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
    for (int ks = kg; ks < ksteps; ks += R::kKGroups) {
      const int kk = ks * 16;
      uint32_t a[4];  // lane l addresses row l%16, k half l/16
      ldmatrix_x4(a, a_st + (lane & 15) * kLda + kk + (lane >> 4) * 8);
      const bf16* w_k = w_res + k0 + kk + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // n-tiles n0 + 2p and n0 + 2p + 1: lane l addresses row l%8 of
        // n-tile n0 + 2p + l/16, k half (l/8)%2
        const int nrow = (n0 + 2 * p + (lane >> 4)) * 8 + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4(b, w_k + (size_t)nrow * ldw);
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
      uint32_t b2[2];  // n-tile n0 + 4: lanes 0-15 address, 16-31 repeat them
      ldmatrix_x2(b2, w_k + (size_t)((n0 + 4) * 8 + (lane & 7)) * ldw);
      mma_bf16(acc[4], a, b2[0], b2[1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp has read the ring: it becomes the partials
  float* mine = part + (size_t)kg * kRows * R::kCols;
#pragma unroll
  for (int n = 0; n < 5; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (lane >> 2) + 8 * half;
      *reinterpret_cast<float2*>(mine + row * R::kCols + (n0 + n) * 8 +
                                 2 * (lane & 3)) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
  __syncthreads();
}

// The launch walks its directions from F on (direction 0 is the forward
// one, 1 the backward one), H/U blocks each: blocks 0 .. H/U - 1 the first.
// F is a template parameter: a run-time first direction changed K1's
// register allocation and made it measurably slower. wp_*: (H/U, 4U, H) bf16, row g*U + j of a tile
// the H weights of gate g of unit U*tile + j. hbuf (directions, 2, B, H)
// bf16 with each direction's buffer 0 zeroed, cbuf (directions, B, H) f32
// zeroed, both indexed by the direction's place in the launch. `hidden` is a
// multiple of 80.
template <typename T, int U, int F>
__global__ void __launch_bounds__(kThreads)
bilstm_resident_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                     const bf16* __restrict__ wp_f,
                     const bf16* __restrict__ wp_b, T* ys_f, T* ys_b,
                     bf16* cs_f, bf16* cs_b, bf16* gs_f, bf16* gs_b,
                     bf16* hbuf, float* cbuf, int n_steps, int batch,
                     int hidden) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char resident_smem[];
  bf16* w_res = reinterpret_cast<bf16*>(resident_smem);
  constexpr int kCols = ResTile<U>::kCols;
  const int ldw = hidden + 8;
  bf16* ring = w_res + (size_t)kCols * ldw;
  float* part = reinterpret_cast<float*>(ring);
  const int tiles_per_dir = hidden / U;
  const int slot = blockIdx.x / tiles_per_dir;  // place in the launch
  const int dir = F + slot;
  const int u0 = (blockIdx.x % tiles_per_dir) * U;
  const size_t bh = (size_t)batch * hidden;
  const size_t h4 = (size_t)4 * hidden;
  const T* xg = dir ? xg_b : xg_f;
  T* ys = dir ? ys_b : ys_f;
  bf16* cs = dir ? cs_b : cs_f;
  bf16* gs = dir ? gs_b : gs_f;
  bf16* hdir = hbuf + (size_t)slot * 2 * bh;
  float* c_state = cbuf + (size_t)slot * bh;
  // the thread's cells of a 16-row pass
  const int tid = threadIdx.x;
  int rows[2], units[2];
  const int n_mine = pass_cells<U>(tid, rows, units);

  for (int i = tid; i < kResRingElems; i += kThreads)
    ring[i] = __float2bfloat16(0.0f);
  load_resident(w_res,
                (dir ? wp_b : wp_f) +
                    (size_t)(blockIdx.x % tiles_per_dir) * kCols * hidden,
                hidden, kCols, hidden);

  for (int s = 0; s < n_steps; ++s) {
    const int t = dir ? n_steps - 1 - s : s;
    const bf16* h_prev = hdir + (size_t)(s & 1) * bh;
    bf16* h_next = hdir + (size_t)((s & 1) ^ 1) * bh;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int nr = min(kRows, batch - r0);
      // the cells' global loads start ahead of the product
      float gate[2][4], c_prev[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool live = q < n_mine && rows[q] < nr;
        const size_t xrow =
            ((size_t)t * batch + r0 + rows[q]) * h4 + u0 + units[q];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gate[q][g] = live ? to_f(xg[xrow + (size_t)g * hidden]) : 0.0f;
        c_prev[q] =
            live ? c_state[(size_t)(r0 + rows[q]) * hidden + u0 + units[q]]
                 : 0.0f;
      }
      resident_product<U>(h_prev + (size_t)r0 * hidden, hidden, nr, hidden, w_res,
                     ldw, ring, part);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= n_mine || rows[q] >= nr) continue;
        const size_t bu = (size_t)(r0 + rows[q]) * hidden + u0 + units[q];
        const size_t xrow =
            ((size_t)t * batch + r0 + rows[q]) * h4 + u0 + units[q];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = 0.0f;
#pragma unroll
          for (int k = 0; k < ResTile<U>::kKGroups; ++k)
            sum += part[((size_t)k * kRows + rows[q]) * kCols + g * U +
                        units[q]];
          gate[q][g] += sum;
        }
        const float ig = sigmoid_f(gate[q][0]);
        const float fg = sigmoid_f(gate[q][1]);
        const float gg = tanhf(gate[q][2]);
        const float og = sigmoid_f(gate[q][3]);
        const float c_new = fg * c_prev[q] + ig * gg;
        const float h_new = og * tanhf(c_new);
        c_state[bu] = c_new;
        h_next[bu] = __float2bfloat16(h_new);
        const size_t o = (size_t)t * bh + bu;
        put(ys + o, h_new);
        if (cs != nullptr) cs[o] = __float2bfloat16(c_new);
        if (gs != nullptr) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gs[xrow + (size_t)g * hidden] = __float2bfloat16(gate[q][g]);
        }
      }
      __syncthreads();  // the partials become the ring again
    }
    grid.sync();
  }
}

template <typename T, int U, int F>
int launch_resident(const void* xg_f, const void* xg_b, const void* wp_f,
                  const void* wp_b, void* ys_f, void* ys_b, void* cs_f,
                  void* cs_b, void* gs_f, void* gs_b, void* hbuf, void* cbuf,
                  int n_steps, int batch, int hidden, int n_dirs,
                  cudaStream_t stream) {
  if (hidden < 80 || hidden % 80 != 0 || n_steps < 1 || batch < 1 ||
      n_dirs < 1 || F + n_dirs > 2)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&xg_f, &xg_b, &wp_f, &wp_b, &ys_f, &ys_b, &cs_f, &cs_b,
                  &gs_f, &gs_b, &hbuf, &cbuf, &n_steps, &batch, &hidden};
  return coop_launch((const void*)bilstm_resident_kernel<T, U, F>,
                     resident_smem_bytes<U>(hidden), n_dirs * (hidden / U),
                     true, args, stream);
}

}  // namespace

// Both return a cudaError_t code (0 on success). xg_bf16 selects the dtype of
// xg_* and ys_* (1: bf16, 0: f32). Null cs_*/gs_* pointers skip the stash
// stores. All pointers come from fresh PyTorch allocations (256-byte
// aligned).
//
// bilstm_fwd_resident: directions first_dir .. first_dir + n_dirs - 1 (0
// forward, 1 backward), the pointers of a direction outside them unread;
// `units` a block: 20 with first_dir 0 (K1, both directions), or 10 with
// either first direction (K5f's narrow form, one direction;
// ops/kernels/lstm.py); hbuf (n_dirs, 2 buffers, B, H) bf16 with each
// buffer 0 zeroed, cbuf (n_dirs, B, H) f32 zeroed; wp_* packed (H/units,
// 4*units, H); `hidden` a multiple of 80 (the wrapper pads with units whose
// weights and inputs are zero).
extern "C" int bilstm_fwd_resident(const void* xg_f, const void* xg_b,
                                 const void* wp_f, const void* wp_b,
                                 void* ys_f, void* ys_b, void* cs_f,
                                 void* cs_b, void* gs_f, void* gs_b,
                                 void* hbuf, void* cbuf, int n_steps,
                                 int batch, int hidden, int first_dir,
                                 int n_dirs, int units, int xg_bf16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BILSTM_FWD_CASE(UV, FV)                                               \
  return xg_bf16 ? launch_resident<bf16, UV, FV>(                             \
                       xg_f, xg_b, wp_f, wp_b, ys_f, ys_b, cs_f, cs_b, gs_f,  \
                       gs_b, hbuf, cbuf, n_steps, batch, hidden, n_dirs, st) \
                 : launch_resident<float, UV, FV>(                            \
                       xg_f, xg_b, wp_f, wp_b, ys_f, ys_b, cs_f, cs_b, gs_f,  \
                       gs_b, hbuf, cbuf, n_steps, batch, hidden, n_dirs, st)
  if (units == 20 && first_dir == 0) BILSTM_FWD_CASE(20, 0);
  if (units == 10 && first_dir == 0) BILSTM_FWD_CASE(10, 0);
  if (units == 10 && first_dir == 1) BILSTM_FWD_CASE(10, 1);
#undef BILSTM_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

// bilstm_fwd (below): hbuf (2 directions, 2 buffers, B, H) bf16 with buffer
// 0 of each direction zeroed, cbuf (2 directions, B, H) f32 zeroed.

// bilstm_fwd: the streamed form. wp_* packed (H/ut, H, 4, ut); `ut` (1, 2, 4
// or 8) must divide `hidden`.
extern "C" int bilstm_fwd(const void* xg_f, const void* xg_b,
                          const void* wp_f, const void* wp_b, void* ys_f,
                          void* ys_b, void* cs_f, void* cs_b, void* gs_f,
                          void* gs_b, void* hbuf, void* cbuf, int n_steps,
                          int batch, int hidden, int ut, int xg_bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ut != 1 && ut != 2 && ut != 4 && ut != 8) || hidden % ut != 0 ||
      n_steps < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  if (xg_bf16)
    return launch_streamed<bf16>(xg_f, xg_b, wp_f, wp_b, ys_f, ys_b, cs_f,
                                 cs_b, gs_f, gs_b, hbuf, cbuf, n_steps, batch,
                                 hidden, ut, st);
  return launch_streamed<float>(xg_f, xg_b, wp_f, wp_b, ys_f, ys_b, cs_f, cs_b,
                                gs_f, gs_b, hbuf, cbuf, n_steps, batch, hidden,
                                ut, st);
}
