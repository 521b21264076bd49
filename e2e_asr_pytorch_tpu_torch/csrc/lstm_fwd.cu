// Single-direction LSTM forward recurrence for Hopper (sm_90a), in the two
// forms the TPU package has.
//
// lstm_fwd_resident_kernel replaces `_fwd_kernel` / `_lstm_fwd_pallas`
// (e2e_asr_pytorch_tpu/ops/pallas/lstm.py): w_h is held on chip for the
// whole sequence; `reverse` walks t = T-1..0 by indexing, no flips.
// lstm_fwd_chunked_kernel replaces `_fwd_kernel_chunked` /
// `_lstm_fwd_pallas_chunked`: the same forward for a w_h too large to hold,
// streamed every step in chunks with the partial gates accumulated before
// the step's elementwise work; forward order only.
//
// Both compute, from a zero state, per step
//
//     gates = xg[t] + bf16(h_prev) @ bf16(w_h)      (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid  (gate order i,f,g,o)
//     c = f * c_prev + i * g ;  h = o * tanh(c)     (c and h carried in f32)
//
// and write ys in xg's dtype (f32 or bf16) and, when their pointers are
// non-null, the bf16 stashes of c and of the f32 gate pre-activations.
//
// Design. One persistent cooperative launch per layer and a grid barrier
// per step. A block owns a tile of UT hidden units (their 4*UT gate
// columns, for all B rows) so a unit's cell state is touched by its owner
// only; bf16(h) is exchanged through a double-buffered global buffer. Per
// step a block forms (B x H) @ (H x 4UT) on the tensor cores (mma.sync
// m16n8k16 bf16, f32 sums; see lstm_common.cuh): the batch is the M axis, in
// passes of 128 rows, one 16-row tile per warp. The tile's gate columns are
// ordered gate-major, so a thread's accumulator fragments hold all four
// gates of its (row, unit) cells and the cell update needs no exchange.
//   resident: the block's slab of w_h, (4UT x H) bf16, is copied to shared
//     memory once and stays for T steps; only h is streamed per step. One
//     tile per block: H/UT tiles must fit the grid and the slab the block's
//     shared memory (H=1024: 128 tiles of 8 units, 66 KB each).
//   chunked: the slab is streamed from L2 every step in the same k-chunks
//     as h, the partial gates accumulating in the fragments; blocks loop
//     over tiles, so any H runs (H=2048: 128 tiles of 16 units, a 256 KB
//     slab per tile that no block could hold).
//
// Bound on the H100. T steps run strictly in sequence; per step every block
// re-reads bf16(h) (B x H) and, chunked, its slab from L2: at B=128, H=2048
// that is 128 x (512 KB + 256 KB) = 98 MB of L2 reads against 4.3 GFLOP.
// Measured, neither binds yet: the step's time follows the number of
// k-chunk iterations (a wait, a block barrier, a few ldmatrix + mma per
// warp at 8 warps an SM) plus ~10 us of grid barrier and cell update, not
// the bytes (a deeper ring, staggered chunk order and fewer bytes each
// changed nothing). Larger chunks, more warps, wgmma and TMA multicast of h
// across a cluster are later work.
//
// Plain C interface, loaded with ctypes (see ops/kernels/lstm.py).

#include "lstm_common.cuh"

namespace {

using namespace lstm;

// wp:   packed w_h, (H/UT, 4*UT, H) bf16 -- per tile, row g*UT + j holds the
//       H weights of gate g of unit u0 + j (column g*H + u0 + j of w_h).
// hbuf: (2 buffers, B, H) bf16, buffer 0 zeroed by the caller.
// cbuf: (B, H) f32, zeroed by the caller.
template <typename T, int UT, bool RESIDENT>
__device__ __forceinline__ void lstm_fwd_body(
    const T* __restrict__ xg, const bf16* __restrict__ wp, T* ys, bf16* cs,
    bf16* gs, bf16* hbuf, float* cbuf, int n_steps, int batch, int hidden,
    int reverse) {
  constexpr int OCT = UT / 8;  // 8-unit groups per tile
  constexpr int NC = 4 * UT;   // gate columns per tile
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_res = reinterpret_cast<bf16*>(smem_raw);
  const int ld_res = hidden + 8;
  bf16* a_s = w_res + (RESIDENT ? (size_t)NC * ld_res : 0);
  bf16* w_s = a_s + kStages * kRowBlock * kKS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = hidden / UT;
  const size_t bh = (size_t)batch * hidden;
  const size_t h4 = (size_t)4 * hidden;

  if (RESIDENT)
    load_resident(w_res, wp + (size_t)blockIdx.x * NC * hidden, hidden, NC,
                  hidden);

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const bf16* h_prev = hbuf + (size_t)(s & 1) * bh;
    bf16* h_next = hbuf + (size_t)((s & 1) ^ 1) * bh;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int u0 = tile * UT;
      const bf16* w_g = wp + (size_t)tile * NC * hidden;
      for (int r0 = 0; r0 < batch; r0 += kRowBlock) {
        const int nr = min(kRowBlock, batch - r0);
        const int m_tiles = (nr + 15) >> 4;
        // a warp's work items: (16-row tile, 8-unit group). Up to 8 items
        // go one to a warp; 16 (128 rows x 2 groups) two to a warp.
        int mt[OCT], oc[OCT];
        bool act[OCT];
        if (m_tiles * OCT > kWarps) {
#pragma unroll
          for (int q = 0; q < OCT; ++q) {
            mt[q] = warp;
            oc[q] = q;
            act[q] = warp < m_tiles;
          }
        } else {
#pragma unroll
          for (int q = 0; q < OCT; ++q) {
            mt[q] = warp / OCT;
            oc[q] = warp % OCT;
            act[q] = q == 0 && warp < m_tiles * OCT;
          }
        }
        float acc[OCT][4][4];
#pragma unroll
        for (int q = 0; q < OCT; ++q)
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][g][e] = 0.0f;

        // Element e of every gate's fragment of item q is the cell (row
        // lane/4 + 8*(e/2), unit 2*(lane%4) + e%2). Start the cell's global
        // loads (xg gates from HBM, c) now, ahead of the product.
        float pre[OCT][4][5];
#pragma unroll
        for (int q = 0; q < OCT; ++q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = mt[q] * 16 + (lane >> 2) + (e >> 1) * 8;
            const bool cell = act[q] && rl < nr;
            const int u = u0 + oc[q] * 8 + 2 * (lane & 3) + (e & 1);
            const size_t row = ((size_t)t * batch + r0 + rl) * h4;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              pre[q][e][g] =
                  cell ? to_f(xg[row + (size_t)g * hidden + u]) : 0.0f;
            pre[q][e][4] =
                cell ? cbuf[(size_t)(r0 + rl) * hidden + u] : 0.0f;
          }
        }

        stream_k<RESIDENT>(
            h_prev + (size_t)r0 * hidden, hidden, nr, w_g, hidden, NC, a_s,
            w_s, hidden, [&](int st, int k0, int klen) {
              const bf16* a_st = a_s + st * kRowBlock * kKS;
              const bf16* w_b = RESIDENT ? w_res + k0 : w_s + st * NC * kKS;
              const int ldw = RESIDENT ? ld_res : kKS;
              for_k16(klen, [&](int kk) {
#pragma unroll
                for (int q = 0; q < OCT; ++q) {
                  if (!act[q]) continue;
                  uint32_t a[4];
                  load_a_frag(a, a_st, mt[q], kk, lane);
#pragma unroll
                  for (int p = 0; p < 2; ++p) {
                    // gates 2p and 2p+1: lane l addresses row l%8 of the
                    // n-tile of gate 2p + l/16, k half (l/8)%2
                    const int nrow =
                        (2 * p + (lane >> 4)) * UT + oc[q] * 8 + (lane & 7);
                    uint32_t b[4];
                    ldmatrix_x4(b, w_b + (size_t)nrow * ldw + kk +
                                       ((lane >> 3) & 1) * 8);
                    mma_bf16(acc[q][2 * p], a, b[0], b[1]);
                    mma_bf16(acc[q][2 * p + 1], a, b[2], b[3]);
                  }
                }
              });
            });

        // cell update from the fragments
#pragma unroll
        for (int q = 0; q < OCT; ++q) {
          if (!act[q]) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = mt[q] * 16 + (lane >> 2) + (e >> 1) * 8;
            if (rl >= nr) continue;
            const int u = u0 + oc[q] * 8 + 2 * (lane & 3) + (e & 1);
            const size_t row = ((size_t)t * batch + r0 + rl) * h4;
            const size_t bu = (size_t)(r0 + rl) * hidden + u;
            float gate[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              gate[g] = pre[q][e][g] + acc[q][g][e];
            const float ig = sigmoid_f(gate[0]);
            const float fg = sigmoid_f(gate[1]);
            const float gg = tanhf(gate[2]);
            const float og = sigmoid_f(gate[3]);
            const float c_new = fg * pre[q][e][4] + ig * gg;
            const float h_new = og * tanhf(c_new);
            cbuf[bu] = c_new;
            h_next[bu] = __float2bfloat16(h_new);
            const size_t o = (size_t)t * bh + bu;
            put(ys + o, h_new);
            if (cs != nullptr) cs[o] = __float2bfloat16(c_new);
            if (gs != nullptr) {
#pragma unroll
              for (int g = 0; g < 4; ++g)
                gs[row + (size_t)g * hidden + u] = __float2bfloat16(gate[g]);
            }
          }
        }
      }
    }
    grid.sync();
  }
}

template <typename T, int UT>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_resident_kernel(const T* xg, const bf16* wp, T* ys, bf16* cs,
                         bf16* gs, bf16* hbuf, float* cbuf, int n_steps,
                         int batch, int hidden, int reverse) {
  lstm_fwd_body<T, UT, true>(xg, wp, ys, cs, gs, hbuf, cbuf, n_steps, batch,
                             hidden, reverse);
}

template <typename T, int UT>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_chunked_kernel(const T* xg, const bf16* wp, T* ys, bf16* cs,
                        bf16* gs, bf16* hbuf, float* cbuf, int n_steps,
                        int batch, int hidden, int reverse) {
  lstm_fwd_body<T, UT, false>(xg, wp, ys, cs, gs, hbuf, cbuf, n_steps, batch,
                              hidden, 0);
}

template <typename T, int UT>
int launch(bool resident, const void* xg, const void* wp, void* ys, void* cs,
           void* gs, void* hbuf, void* cbuf, int n_steps, int batch,
           int hidden, int reverse, cudaStream_t stream) {
  const void* kernel =
      resident ? (const void*)lstm_fwd_resident_kernel<T, UT>
               : (const void*)lstm_fwd_chunked_kernel<T, UT>;
  const size_t smem = resident
                          ? resident_bytes(4 * UT, hidden) + ring_bytes(0)
                          : ring_bytes(4 * UT);
  void* args[] = {&xg, &wp, &ys, &cs, &gs, &hbuf, &cbuf,
                  &n_steps, &batch, &hidden, &reverse};
  return coop_launch(kernel, smem, hidden / UT, resident, args, stream);
}

int dispatch(bool resident, const void* xg, const void* wp, void* ys, void* cs,
             void* gs, void* hbuf, void* cbuf, int n_steps, int batch,
             int hidden, int ut, int reverse, int xg_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ut != 8 && ut != 16) || hidden % ut != 0 || hidden % 16 != 0 ||
      n_steps < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
#define LSTM_FWD_CASE(TYPE, UTV)                                            \
  return launch<TYPE, UTV>(resident, xg, wp, ys, cs, gs, hbuf, cbuf,        \
                           n_steps, batch, hidden, reverse, st)
  if (xg_bf16) {
    if (ut == 8) LSTM_FWD_CASE(bf16, 8);
    LSTM_FWD_CASE(bf16, 16);
  }
  if (ut == 8) LSTM_FWD_CASE(float, 8);
  LSTM_FWD_CASE(float, 16);
#undef LSTM_FWD_CASE
}

}  // namespace

// Both return a cudaError_t code (0 on success). xg_bf16 selects the dtype
// of xg and ys (1: bf16, 0: f32). `ut` (8 or 16) must divide `hidden`, and
// `hidden` must be a multiple of 16 (the wrapper pads). Null cs/gs pointers
// skip the stash stores. All pointers come from fresh PyTorch allocations
// (256-byte aligned).
extern "C" int lstm_fwd_resident(const void* xg, const void* wp, void* ys,
                                 void* cs, void* gs, void* hbuf, void* cbuf,
                                 int n_steps, int batch, int hidden, int ut,
                                 int reverse, int xg_bf16, void* stream) {
  return dispatch(true, xg, wp, ys, cs, gs, hbuf, cbuf, n_steps, batch, hidden,
                  ut, reverse, xg_bf16, stream);
}

extern "C" int lstm_fwd_chunked(const void* xg, const void* wp, void* ys,
                                void* cs, void* gs, void* hbuf, void* cbuf,
                                int n_steps, int batch, int hidden, int ut,
                                int xg_bf16, void* stream) {
  return dispatch(false, xg, wp, ys, cs, gs, hbuf, cbuf, n_steps, batch,
                  hidden, ut, 0, xg_bf16, stream);
}
