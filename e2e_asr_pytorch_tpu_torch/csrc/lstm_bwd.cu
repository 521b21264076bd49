// Single-direction LSTM backward recurrence for Hopper (sm_90a), in the two
// forms the TPU package has.
//
// lstm_bwd_resident_kernel replaces `_bwd_kernel` / `_lstm_bwd_pallas`
// (e2e_asr_pytorch_tpu/ops/pallas/lstm.py): w_h held on chip, the forward's
// order (plain or `reverse`) walked backwards, dxg emitted in bf16.
// lstm_bwd_chunked_kernel replaces `_bwd_kernel_chunked` /
// `_lstm_bwd_pallas_chunked`: w_h streamed every step in chunks with the
// partial dh accumulated before the step's elementwise work; forward order
// only; dxg emitted in f32, unrounded, and only the operand of the dh
// product rounded to bf16.
//
// Both walk the forward scan in reverse from its bf16 stashes (cell states
// cs, gate pre-activations gates); per step
//
//     i, f, g, o   = act(gates[t])                    (f32 from the stash)
//     dh           = dy[t] + bf16(dgates_prev) @ bf16(w_h)^T   (f32 acc.)
//     do           = dh * tanh(c[t])
//     dc           = dc_carry + dh * o * (1 - tanh(c[t])^2)
//     dgates       = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2),
//                     do*o*(1-o)]
//     dxg[t]       = dgates ;  dc_carry = dc * f
//
// where dgates_prev is the previous backward step's and c_prev the cell
// state the forward scan saw before t (zero at the scan's start). dW_h is
// one matmul outside the kernel (ops/kernels/lstm.py).
//
// Design. As the forward (lstm_fwd.cu): one persistent cooperative launch
// and a grid barrier per step. A block owns a tile of (a block of batch
// rows) x (UT hidden units) for the whole walk, so a cell's dc carry is
// touched by its owner only. Per step a block forms (rows x 4H) @ (4H x UT)
// on the tensor cores: A is the previous step's bf16 dgates of its rows,
// streamed from L2 in k-chunks; Wt is the block's UT rows of w_h, contiguous
// in the (H,4H) layout, so no packing is needed. Every block must re-read
// its rows of A in full, 4H wide, so the rows are split across blocks as
// well as the units: H/UT unit tiles times as many row blocks as fill one
// block per SM (B=128, H=2048: 64 tiles of 32 units x 2 blocks of 64 rows,
// 201 MB of L2 reads a step where 128 tiles of 16 units x all rows read
// 302 MB). A warp takes one 16-row tile and one or two 8-unit n-tiles.
//   resident (UT = 16): the block's rows of w_h (16 x 4H bf16; H=1024:
//     131 KB) stay in shared memory for T steps, and the bf16 dxg rows
//     written at the previous step are themselves the exchange buffer.
//   chunked (UT = 32): the rows of w_h are streamed every step beside A,
//     the partial dh accumulating in the fragments; dxg is f32, so
//     bf16(dgates) goes through a separate double-buffered (2,B,4H)
//     exchange buffer; blocks loop over tiles, so any H and B run.
//
// Bound on the H100. The same 2*B*H*4H operations a step as the forward
// against twice its L2 traffic (the contraction runs over 4H, four times the
// forward's k-chunk iterations). Measured, the step's time follows the
// number of those iterations, not the bytes (see lstm_fwd.cu). Larger
// chunks, TMA multicast of the dgates rows across a cluster and wgmma are
// later work.
//
// Plain C interface, loaded with ctypes (see ops/kernels/lstm.py).

#include "lstm_common.cuh"

namespace {

using namespace lstm;

// gs: gate stash (T,B,4H) bf16; cs: cell stash (T,B,H) bf16; wh: w_h (H,4H)
// bf16; dy (T,B,H) in the stream dtype T; dcbuf (B,H) f32 zeroed by the
// caller; rblk: batch rows per row block (a multiple of 16). RESIDENT: dxg
// (T,B,4H) bf16, xbuf unused. Chunked: dxg (T,B,4H) f32 and xbuf (2,B,4H)
// bf16.
template <typename T, int UT, bool RESIDENT>
__device__ __forceinline__ void lstm_bwd_body(
    const bf16* __restrict__ gs, const bf16* __restrict__ wh,
    const bf16* __restrict__ cs, const T* __restrict__ dy, void* dxg_out,
    bf16* xbuf, float* dcbuf, int n_steps, int batch, int hidden, int rblk,
    int reverse) {
  constexpr int NT = UT / 8;  // n8 tiles of the block's units
  // rows per pass: at most 16 (16-row x 8-unit) items, two to a warp
  constexpr int PASS = 2048 / UT < kRowBlock ? 2048 / UT : kRowBlock;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k_all = 4 * hidden;
  bf16* w_res = reinterpret_cast<bf16*>(smem_raw);
  const int ld_res = k_all + 8;
  bf16* a_s = w_res + (RESIDENT ? (size_t)UT * ld_res : 0);
  bf16* w_s = a_s + kStages * kRowBlock * kKS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_ut = hidden / UT;
  const int n_tiles = n_ut * ((batch + rblk - 1) / rblk);
  const size_t bh = (size_t)batch * hidden;
  const size_t h4 = (size_t)k_all;
  bf16* dxg_bf = static_cast<bf16*>(dxg_out);
  float* dxg_f32 = static_cast<float*>(dxg_out);

  if (RESIDENT)
    load_resident(w_res, wh + (size_t)(blockIdx.x % n_ut) * UT * h4, h4, UT,
                  k_all);

  for (int s = 0; s < n_steps; ++s) {
    // a plain forward is walked T-1..0, a reversed one 0..T-1
    const int t = reverse ? s : n_steps - 1 - s;
    const int t_prev = reverse ? t - 1 : t + 1;  // visited at step s-1
    const int t_cp = reverse ? t + 1 : t - 1;    // forward-scan predecessor
    const bool has_cp = t_cp >= 0 && t_cp < n_steps;
    const bf16* a_all = RESIDENT ? dxg_bf + (size_t)t_prev * batch * h4
                                 : xbuf + (size_t)(s & 1) * batch * h4;
    bf16* x_next = xbuf + (size_t)((s & 1) ^ 1) * batch * h4;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int u0 = (tile % n_ut) * UT;
      const int row_lo = (tile / n_ut) * rblk;
      const int row_hi = min(batch, row_lo + rblk);
      const bf16* w_g = wh + (size_t)u0 * h4;
      for (int r0 = row_lo; r0 < row_hi; r0 += PASS) {
        const int nr = min(PASS, row_hi - r0);
        const int m_tiles = (nr + 15) >> 4;
        // a warp's work: one 16-row tile and, when the pass has more than 8
        // (16-row x 8-unit) items, two adjacent n-tiles, else one
        const bool two = m_tiles * NT > kWarps;
        const int per_mt = two ? NT / 2 : NT;
        const int mt = warp / per_mt;
        const int nt0 = (warp % per_mt) * (two ? 2 : 1);
        const bool act = mt < m_tiles;
        float acc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

        // Element e of the warp's n-tile n is the cell (row lane/4 +
        // 8*(e/2), unit 8*(nt0+n) + 2*(lane%4) + e%2). Start the cell's
        // global loads (the stashes, dy, dc) now, ahead of the product:
        // gates i,f,g,o, c_t, c_prev, dy, dc.
        float pre[2][4][8];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = mt * 16 + (lane >> 2) + (e >> 1) * 8;
            const bool cell = act && rl < nr && (n == 0 || two);
            const int u = u0 + (nt0 + n) * 8 + 2 * (lane & 3) + (e & 1);
            const size_t grow = ((size_t)t * batch + r0 + rl) * h4;
            const size_t bu = (size_t)(r0 + rl) * hidden + u;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              pre[n][e][g] =
                  cell ? __bfloat162float(gs[grow + (size_t)g * hidden + u])
                       : 0.0f;
            pre[n][e][4] =
                cell ? __bfloat162float(cs[(size_t)t * bh + bu]) : 0.0f;
            pre[n][e][5] = cell && has_cp
                               ? __bfloat162float(cs[(size_t)t_cp * bh + bu])
                               : 0.0f;
            pre[n][e][6] = cell ? to_f(dy[(size_t)t * bh + bu]) : 0.0f;
            pre[n][e][7] = cell ? dcbuf[bu] : 0.0f;
          }
        }

        if (s > 0) {
          stream_k<RESIDENT>(
              a_all + (size_t)r0 * h4, h4, nr, w_g, h4, UT, a_s, w_s, k_all,
              [&](int st, int k0, int klen) {
                if (!act) return;
                const bf16* a_st = a_s + st * kRowBlock * kKS;
                const bf16* w_b = RESIDENT ? w_res + k0 : w_s + st * UT * kKS;
                const int ldw = RESIDENT ? ld_res : kKS;
                // lane l addresses row l%8 of n-tile nt0 (+ l/16 when the
                // warp has two), k half (l/8)%2
                const int nrow = (nt0 + (two ? lane >> 4 : 0)) * 8 + (lane & 7);
                const bf16* bp = w_b + (size_t)nrow * ldw + ((lane >> 3) & 1) * 8;
                for_k16(klen, [&](int kk) {
                  uint32_t a[4];
                  load_a_frag(a, a_st, mt, kk, lane);
                  if (two) {
                    uint32_t b[4];
                    ldmatrix_x4(b, bp + kk);
                    mma_bf16(acc[0], a, b[0], b[1]);
                    mma_bf16(acc[1], a, b[2], b[3]);
                  } else {
                    uint32_t b[2];
                    ldmatrix_x2(b, bp + kk);
                    mma_bf16(acc[0], a, b[0], b[1]);
                  }
                });
              });
        }

        // gate backward from the fragments
        if (act) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            if (n == 1 && !two) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rl = mt * 16 + (lane >> 2) + (e >> 1) * 8;
              if (rl >= nr) continue;
              const int u = u0 + (nt0 + n) * 8 + 2 * (lane & 3) + (e & 1);
              const size_t grow = ((size_t)t * batch + r0 + rl) * h4;
              const size_t bu = (size_t)(r0 + rl) * hidden + u;
              const float* in = pre[n][e];
              const float dh = in[6] + acc[n][e];
              const float ig = sigmoid_f(in[0]);
              const float fg = sigmoid_f(in[1]);
              const float gg = tanhf(in[2]);
              const float og = sigmoid_f(in[3]);
              const float tc = tanhf(in[4]);
              const float c_prev = in[5];
              const float d_o = dh * tc;
              const float dct = in[7] + dh * og * (1.0f - tc * tc);
              const float dg[4] = {dct * gg * ig * (1.0f - ig),
                                   dct * c_prev * fg * (1.0f - fg),
                                   dct * ig * (1.0f - gg * gg),
                                   d_o * og * (1.0f - og)};
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                const size_t col = (size_t)g * hidden + u;
                if (RESIDENT) {
                  dxg_bf[grow + col] = __float2bfloat16(dg[g]);
                } else {
                  dxg_f32[grow + col] = dg[g];
                  x_next[(size_t)(r0 + rl) * h4 + col] =
                      __float2bfloat16(dg[g]);
                }
              }
              dcbuf[bu] = dct * fg;
            }
          }
        }
      }
    }
    grid.sync();
  }
}

constexpr int kResidentUnits = 16;
constexpr int kChunkedUnits = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_resident_kernel(const bf16* gs, const bf16* wh, const bf16* cs,
                         const T* dy, void* dxg, bf16* xbuf, float* dcbuf,
                         int n_steps, int batch, int hidden, int rblk,
                         int reverse) {
  lstm_bwd_body<T, kResidentUnits, true>(gs, wh, cs, dy, dxg, xbuf, dcbuf,
                                         n_steps, batch, hidden, rblk,
                                         reverse);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_chunked_kernel(const bf16* gs, const bf16* wh, const bf16* cs,
                        const T* dy, void* dxg, bf16* xbuf, float* dcbuf,
                        int n_steps, int batch, int hidden, int rblk,
                        int reverse) {
  lstm_bwd_body<T, kChunkedUnits, false>(gs, wh, cs, dy, dxg, xbuf, dcbuf,
                                         n_steps, batch, hidden, rblk, 0);
}

template <typename T>
int launch(bool resident, const void* gs, const void* wh, const void* cs,
           const void* dy, void* dxg, void* xbuf, void* dcbuf, int n_steps,
           int batch, int hidden, int reverse, cudaStream_t stream) {
  const void* kernel = resident ? (const void*)lstm_bwd_resident_kernel<T>
                                : (const void*)lstm_bwd_chunked_kernel<T>;
  const int ut = resident ? kResidentUnits : kChunkedUnits;
  const size_t smem = resident
                          ? resident_bytes(ut, 4 * hidden) + ring_bytes(0)
                          : ring_bytes(ut);
  // as many row blocks as give every SM a block, at least 16 rows each
  int device = 0, n_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const int n_ut = hidden / ut;
  int n_rb = n_sm / n_ut;
  if (n_rb > (batch + 15) / 16) n_rb = (batch + 15) / 16;
  if (n_rb < 1) n_rb = 1;
  int rblk = ((batch + n_rb - 1) / n_rb + 15) / 16 * 16;
  n_rb = (batch + rblk - 1) / rblk;
  void* args[] = {&gs, &wh, &cs, &dy, &dxg, &xbuf, &dcbuf,
                  &n_steps, &batch, &hidden, &rblk, &reverse};
  return coop_launch(kernel, smem, n_ut * n_rb, resident, args, stream);
}

int dispatch(bool resident, const void* gs, const void* wh, const void* cs,
             const void* dy, void* dxg, void* xbuf, void* dcbuf, int n_steps,
             int batch, int hidden, int reverse, int dy_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden % 32 != 0 || n_steps < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  if (dy_bf16)
    return launch<bf16>(resident, gs, wh, cs, dy, dxg, xbuf, dcbuf, n_steps,
                        batch, hidden, reverse, st);
  return launch<float>(resident, gs, wh, cs, dy, dxg, xbuf, dcbuf, n_steps,
                       batch, hidden, reverse, st);
}

}  // namespace

// Both return a cudaError_t code (0 on success). dy_bf16 selects the dtype
// of dy (1: bf16, 0: f32); the stashes and w_h are bf16, dcbuf f32. `hidden`
// must be a multiple of 32 (the wrapper pads). lstm_bwd_resident writes dxg
// in bf16 and needs H/16 <= the card's SMs and a 16 x (4H+8) bf16 slab beside
// the ring in a block's shared memory; lstm_bwd_chunked writes dxg in f32
// and needs the (2,B,4H) bf16 exchange buffer xbuf.
extern "C" int lstm_bwd_resident(const void* gs, const void* wh,
                                 const void* cs, const void* dy, void* dxg,
                                 void* dcbuf, int n_steps, int batch,
                                 int hidden, int reverse, int dy_bf16,
                                 void* stream) {
  return dispatch(true, gs, wh, cs, dy, dxg, nullptr, dcbuf, n_steps, batch,
                  hidden, reverse, dy_bf16, stream);
}

extern "C" int lstm_bwd_chunked(const void* gs, const void* wh, const void* cs,
                                const void* dy, void* dxg, void* xbuf,
                                void* dcbuf, int n_steps, int batch,
                                int hidden, int dy_bf16, void* stream) {
  return dispatch(false, gs, wh, cs, dy, dxg, xbuf, dcbuf, n_steps, batch,
                  hidden, 0, dy_bf16, stream);
}
