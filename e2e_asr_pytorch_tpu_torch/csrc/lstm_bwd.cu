// Single-direction LSTM backward recurrence for Hopper (sm_90a):
// lstm_bwd_chunked_kernel, in two forms, serves two TPU kernels of
// e2e_asr_pytorch_tpu/ops/pallas/lstm.py.
//
//   K6b  `_bwd_kernel_chunked` / `_lstm_bwd_pallas_chunked`: a w_h too large
//        to hold, forward order only; dxg emitted in f32, unrounded, only
//        the operand of the dh product rounded to bf16; tiles of 32 units x
//        64 rows (the 4x LSTM-2048 LM).
//   K5b  `_bwd_kernel` / `_lstm_bwd_pallas`, at every batch (the 4x
//        LSTM-1024 LM's 128 and the single-direction listener's 16 and 8):
//        the same kernel with the forward's order (plain or `reverse`)
//        walked backwards by indexing, dxg emitted in bf16, and tiles of 16
//        units x 64 rows. K2's resident kernel over one direction measured
//        slower at B = 16 and 8, so K5b has this one form.
//
// It walks the forward scan in reverse from its bf16 stashes (cell states
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
// Design. One persistent cooperative launch. A block owns a tile of (64
// batch rows) x (U hidden units) for the whole walk, so a cell's dc carry is
// touched by its owner only. Per step a block forms (rows x 4H) @ (4H x U):
// A is the previous step's bf16 dgates of its rows, from the exchange
// buffer in L2; B is the tile's rows of w_h. The contraction runs over 4H,
// four times the forward's. What bounds a step on the H100 is the chain of
// T dependent steps, each: grid barrier -> the new dgates rows from L2 ->
// product -> cell update. The mma.sync kernels this one replaced (fed by a
// cp.async ring with a block-wide barrier every 64 k values) waited at those
// barriers and streamed the rows through every warp. What this kernel does
// about it, with the forward's machinery (hopper_async.cuh):
//   - The product is wgmma m64nUk16: the tile's 64 rows as M, its U units
//     as N, both operands K-major from shared memory in the 128-byte
//     swizzle, sums in registers. Two consumer warpgroups take the k-tiles
//     of the contraction in turns (even / odd) for the same output tile, so
//     one's hand-over of a tile overlaps the other's products, and meet once
//     a step to add their partial sums through shared memory, each then
//     updating half of the tile's cells.
//   - A producer warp issues bulk copies into one ring of eight stages, a
//     stage holding a k-tile of the dgates rows and, when streamed, the
//     slab's k-tile, behind one full and one empty mbarrier; no block-wide
//     barrier in the k loop. The images in global memory are already
//     swizzled: a small kernel packs w_h so (lstm_pack_chunked_bwd_kernel),
//     and the cell update writes bf16(dgates) into the exchange buffer so,
//     so a k-tile is one contiguous copy.
//   - A k-tile is 128 k values, as in the forward: every hand-over of a tile
//     costs the tensor cores a pause.
//   - The ring is deep before anything stays resident: with four stages
//     (two a group) every k-tile waited a full copy latency. What the opt-in
//     shared memory leaves beside it holds resident k-tiles of the slab for
//     the whole walk (computed by the wrapper: K6b at H=2048, 3 of 64; K5b
//     at H=1024, 15 of 32), spread evenly over the k loop.
//   - A block's intake a step is its 64 rows of dgates (4H wide) plus the
//     streamed part of its slab: K6b's 32 x 64 tiling keeps it at 1.49 MB at
//     H=2048 (128 units x 16 rows or 16 x 128 would take in 2 MB or more);
//     at H=1024 16-unit tiles (128 blocks, 580 KB a block) measured faster
//     than 32-unit ones (64 blocks, 744 KB a block).
//   - The grid barrier is split: a block arrives once its cells are stored,
//     and only its producer warp waits, before it fetches the new rows.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, bf16: K6b at T=160 B=128
// H=2048 4.41 ms (27.6 us a step) against 7.99 ms for cuDNN's backward
// alone; K5b at T=160 B=128 H=1024 2.20 ms (13.8 us a step) against
// 5.74-5.79 ms for the mma.sync kernel it replaced and 3.5-3.7 ms for
// cuDNN's backward alone, where K6b's 32-unit tiles measured slower; at
// T=400 B=16 H=1280 4.95 ms against 14.1 ms for the kernel it replaced and
// 6.0 ms for K2's kernel over one direction
// (chip_smoke.py, script/torch_k5_time.py, script/torch_k5_forms.py,
// script/torch_k6b_phases.py; PERF.md has the tables and what a step's
// links cost).
//
// Plain C interface, loaded with ctypes (see ops/kernels/lstm.py).

#include "hopper_async.cuh"
#include "lstm_common.cuh"

namespace {

using namespace lstm;

// ---------------------------------------------------------------------------
// chunked (K6b)
// ---------------------------------------------------------------------------

using namespace hopper;

// Geometry (ops/kernels/lstm.py mirrors the sizes). A tile is U hidden units
// (wgmma's n) x kTileRows batch rows (its m).
constexpr int kTileRows = 64;        // batch rows per tile: wgmma's m
constexpr int kConsumerWarps = 8;    // two warpgroups, k-tiles in turns
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kChunkedThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kGroup = 2;            // swizzle atoms of 64 k values a k-tile
constexpr int kKTile = kGroup * kTileK;
constexpr int kGAtom = kTileRows * kTileK;  // bf16 values of an atom of rows
constexpr int kGTile = kGroup * kGAtom;
constexpr uint32_t kGTileBytes = kGTile * sizeof(bf16);  // 16 KB
// One ring: a stage holds a k-tile of dgates rows and, when that k-tile of
// the slab is streamed, the slab's k-tile too, behind one full and one empty
// barrier. The ring is as deep as the shared memory allows, ahead of
// residents: a group's next tiles must be in flight while it works on this
// one.
constexpr int kRingStages = 8;  // four for each group
constexpr int kChains = 2;  // accumulator chains a warpgroup

template <int U>
struct Tile {
  static constexpr int kAcc = U / 2;     // accumulator floats a thread
  static constexpr int kKeep = U / 16;   // n8 tiles each warpgroup updates
  static constexpr int kWAtom = U * kTileK;  // bf16 values of an atom of a slab
  static constexpr int kWTile = kGroup * kWAtom;
  static constexpr uint32_t kWTileBytes = kWTile * sizeof(bf16);
  // the two warpgroups' halves of each other's partial sums: 128 threads x
  // kAcc / 2 floats each way
  static constexpr int kRedFloats = 128 * kAcc;
  // alignment slack + the ring + the partial sums + 1 KB for the barriers;
  // the resident k-tiles lie between the partial sums and the barriers
  static constexpr size_t kFixedBytes =
      1024 + kRingStages * (kGTileBytes + kWTileBytes) +
      kRedFloats * sizeof(float) + 1024;
};

// A walk over the k-tiles kt0, kt0 + step, ... of a slab of n_kt k-tiles,
// n_res of them resident: k-tile kt is resident when the running share of
// resident tiles steps there (floor((kt+1) n_res / n_kt) > floor(kt n_res /
// n_kt)), which spreads the streamed ones evenly over the k loop, and
// `index` counts the resident tiles before kt. Kept by remainders: no
// division per tile.
struct ResidentWalk {
  int n_res, n_kt, step, index, rem;
  __device__ __forceinline__ ResidentWalk(int n_res_, int n_kt_, int kt0,
                                          int step_)
      : n_res(n_res_), n_kt(n_kt_), step(step_) {
    index = kt0 * n_res / n_kt;
    rem = kt0 * n_res - index * n_kt;
  }
  __device__ __forceinline__ bool resident() const {
    return rem + n_res >= n_kt;
  }
  __device__ __forceinline__ void next() {
    rem += step * n_res;
    while (rem >= n_kt) {
      rem -= n_kt;
      ++index;
    }
  }
};

// gs:   gate stash (T,B,4H) bf16; cs: cell stash (T,B,H) bf16; dy (T,B,H)
//       in the stream dtype T.
// wp:   packed w_h, (H/U, 4H/64, U, 64) bf16: unit tile, atom, unit row j
//       (row U*tile + j of w_h), that row's 64 k values of the atom with
//       their 16-byte chunks in the 128-byte swizzle of row j.
// xbuf: (2 buffers, ceil(B/64), 4H/64, 64, 64) bf16, bf16(dgates) of a row
//       block and an atom swizzled the same way by row; zeroed by the caller
//       (buffer 0 is the first step's operand, and rows beyond the batch
//       are read but never written).
// dxg:  (T,B,4H) in D (f32: K6b, unrounded; bf16: K5b). dcbuf: (B,H) f32
//       zeroed. step_counter: one u32 zeroed: the grid barrier.
// A block owns tiles blockIdx.x + i * gridDim.x, i < tiles_per_block (tile
// = row block * H/U + unit tile), and keeps resident_ktiles k-tiles of
// each tile's slab in shared memory. `hidden` is a multiple of 32. Step s
// handles data index t = T-1-s of a plain forward scan, t = s of a reversed
// one (`reverse`).
//
// The grid barrier is split as the forward's: a block arrives (one atomic
// add) when its consumers have stored their cells, and only the producer
// warp waits for all arrivals, before it fetches the new rows. A block runs
// at most one step ahead of the slowest, which the two exchange buffers
// allow.
template <typename T, typename D, int U>
__global__ void __launch_bounds__(kChunkedThreads, 1)
lstm_bwd_chunked_kernel(const bf16* __restrict__ gs,
                        const bf16* __restrict__ wp,
                        const bf16* __restrict__ cs, const T* __restrict__ dy,
                        D* dxg, bf16* xbuf, float* dcbuf,
                        uint32_t* step_counter, int n_steps, int batch,
                        int hidden, int tiles_per_block, int resident_ktiles,
                        int reverse) {
  using G = Tile<U>;
  extern __shared__ unsigned char chunked_smem[];
  unsigned char* base =
      chunked_smem + ((1024 - (shared_addr(chunked_smem) & 1023)) & 1023);
  bf16* g_ring = reinterpret_cast<bf16*>(base);
  bf16* w_ring = g_ring + kRingStages * kGTile;
  float* red = reinterpret_cast<float*>(w_ring + kRingStages * G::kWTile);
  bf16* w_res = reinterpret_cast<bf16*>(red + G::kRedFloats);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      w_res + (size_t)tiles_per_block * resident_ktiles * G::kWTile);
  uint64_t* empty = full + kRingStages;
  uint64_t* res_bar = empty + kRingStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h4 = 4 * hidden;
  const int n_kt = h4 / kKTile;
  const int n_atoms = h4 / kTileK;
  const int n_ut = hidden / U;
  const int n_rb = (batch + kTileRows - 1) / kTileRows;
  const int n_tiles = n_ut * n_rb;
  const size_t buf_elems = (size_t)n_rb * n_kt * kGTile;

  if (tid == 0) {
    // each stage is consumed by the four warps of one group
    for (int i = 0; i < kRingStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);
    }
    mbar_init(res_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer warp: every lane follows the barriers, lane 0 issues ---
    if (lane == 0 && resident_ktiles > 0) {
      mbar_arrive_expect_tx(res_bar, (uint32_t)tiles_per_block *
                                         resident_ktiles * G::kWTileBytes);
      for (int local = 0; local < tiles_per_block; ++local) {
        const int tile = min((int)(blockIdx.x + local * gridDim.x),
                             n_tiles - 1);
        const int ut = tile % n_ut;
        ResidentWalk walk(resident_ktiles, n_kt, 0, 1);
        for (int kt = 0; kt < n_kt; ++kt, walk.next()) {
          if (walk.resident())
            bulk_load(w_res + ((size_t)local * resident_ktiles + walk.index) *
                                  G::kWTile,
                      wp + ((size_t)ut * n_kt + kt) * G::kWTile,
                      G::kWTileBytes, res_bar);
        }
      }
    }
    uint32_t it = 0;
    for (int s = 0; s < n_steps; ++s) {
      const bf16* rows = xbuf + (size_t)(s & 1) * buf_elems;
      // every block has stored its dgates of step s - 1 ...
      const uint32_t arrivals = (uint32_t)s * gridDim.x;
      while (load_acquire(step_counter) < arrivals) {
      }
      // ... with plain stores, which the bulk copies must see
      fence_proxy_async();
      for (int local = 0; local < tiles_per_block; ++local) {
        const int tile = min((int)(blockIdx.x + local * gridDim.x),
                             n_tiles - 1);
        const int ut = tile % n_ut;
        const int rb = tile / n_ut;
        ResidentWalk walk(resident_ktiles, n_kt, 0, 1);
        for (int kt = 0; kt < n_kt; ++kt, walk.next()) {
          const int st = it % kRingStages;
          mbar_wait(empty + st, ((it / kRingStages) & 1) ^ 1);
          ++it;
          if (lane == 0) {
            const bool streamed = !walk.resident();
            mbar_arrive_expect_tx(
                full + st, kGTileBytes + (streamed ? G::kWTileBytes : 0));
            bulk_load(g_ring + st * kGTile,
                      rows + ((size_t)rb * n_kt + kt) * kGTile, kGTileBytes,
                      full + st);
            if (streamed)
              bulk_load(w_ring + st * G::kWTile,
                        wp + ((size_t)ut * n_kt + kt) * G::kWTile,
                        G::kWTileBytes, full + st);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes the k-tiles wg, wg + 2, ... -------
    const int wg = warp >> 2;
    const int idx = (warp & 3) * 32 + lane;  // the same cells in both groups
    const int col2 = 2 * (lane & 3);  // the thread's unit pair in an n-tile
    constexpr int kHalf = G::kAcc / 2;
    if (resident_ktiles > 0) mbar_wait(res_bar, 0);
    uint32_t it = 0;
    for (int s = 0; s < n_steps; ++s) {
      // a plain forward scan is walked T-1..0, a reversed one 0..T-1; c_prev
      // is the cell state the forward scan saw before t
      const int t = reverse ? s : n_steps - 1 - s;
      const int t_cp = reverse ? t + 1 : t - 1;
      const bool has_cp = t_cp >= 0 && t_cp < n_steps;
      bf16* x_next = xbuf + (size_t)((s & 1) ^ 1) * buf_elems;
      for (int local = 0; local < tiles_per_block; ++local) {
        const int tile_raw = blockIdx.x + local * gridDim.x;
        const bool valid = tile_raw < n_tiles;
        const int tile = min(tile_raw, n_tiles - 1);
        const int u0 = (tile % n_ut) * U;
        const int r0 = (tile / n_ut) * kTileRows;
        const int nr = min(kTileRows, batch - r0);
        // The thread's cells after the exchange: rows rl[hh], the unit pairs
        // u0 + 8 n + col2 + {0,1} of n-tiles n = kKeep wg + jj. Their global
        // loads (the stashes, dy, dc) start ahead of the product.
        int rl[2];
        bool ok[2];
        __nv_bfloat162 gate[2][G::kKeep][4], c_t[2][G::kKeep],
            c_p[2][G::kKeep];
        typename Pair<T>::type dyv[2][G::kKeep];
        float2 dc[2][G::kKeep];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rl[hh] = (warp & 3) * 16 + (lane >> 2) + 8 * hh;
          ok[hh] = valid && rl[hh] < nr;
          const size_t grow = ((size_t)t * batch + r0 + rl[hh]) * h4;
          const size_t crow = (size_t)(r0 + rl[hh]) * hidden;
#pragma unroll
          for (int jj = 0; jj < G::kKeep; ++jj) {
            const int u = u0 + 8 * (G::kKeep * wg + jj) + col2;
            if (!ok[hh]) continue;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              gate[hh][jj][g] = load2(gs + grow + (size_t)g * hidden + u);
            c_t[hh][jj] = load2(cs + (size_t)t * batch * hidden + crow + u);
            c_p[hh][jj] =
                has_cp
                    ? load2(cs + (size_t)t_cp * batch * hidden + crow + u)
                    : __floats2bfloat162_rn(0.0f, 0.0f);
            dyv[hh][jj] = load2(dy + (size_t)t * batch * hidden + crow + u);
            dc[hh][jj] = load2(dcbuf + crow + u);
          }
        }

        float acc[kChains][G::kAcc];
#pragma unroll
        for (int c = 0; c < kChains; ++c)
#pragma unroll
          for (int i = 0; i < G::kAcc; ++i) acc[c][i] = 0.0f;
        // k-tile kt of this pass sits in stage (i0 + kt) % kRingStages
        const uint32_t i0 = it;
        auto hand_back = [&](int kt) {
          if (lane == 0) mbar_arrive(empty + (i0 + kt) % kRingStages);
        };
        ResidentWalk walk(resident_ktiles, n_kt, wg, 2);
        for (int kt = wg; kt < n_kt; kt += 2, walk.next()) {
          const uint32_t ik = i0 + kt;
          const int st = ik % kRingStages;
          mbar_wait(full + st, (ik / kRingStages) & 1);
          const bf16* w_tile =
              walk.resident()
                  ? w_res + ((size_t)local * resident_ktiles + walk.index) *
                                G::kWTile
                  : w_ring + st * G::kWTile;
          wgmma_fence();
#pragma unroll
          for (int sub = 0; sub < kGroup; ++sub) {
            const uint64_t da =
                swizzled_desc(g_ring + st * kGTile + sub * kGAtom);
            const uint64_t db = swizzled_desc(w_tile + sub * G::kWAtom);
#pragma unroll
            for (int kk = 0; kk < kTileK / 16; ++kk)
              wgmma_k16(acc[kk % kChains], da + 2 * kk, db + 2 * kk);
          }
          wgmma_commit();
          if (kt >= 2) {  // this group's tile before this one has been read
            wgmma_wait<1>();
            hand_back(kt - 2);
          }
        }
        wgmma_wait<0>();
        {
          const int last = n_kt - 1 - ((n_kt - 1 - wg) & 1);
          if (last >= 0) hand_back(last);
        }
        it = i0 + n_kt;
#pragma unroll
        for (int c = 0; c < kChains; ++c) fence_acc(acc[c]);
#pragma unroll
        for (int c = 1; c < kChains; ++c)
#pragma unroll
          for (int i = 0; i < G::kAcc; ++i) acc[0][i] += acc[c][i];

        // n-tile n of the accumulator is units 8 n .. 8 n + 7 of the tile:
        // group wg keeps n-tiles kKeep wg .. kKeep wg + kKeep - 1 and hands
        // the others to the other group, which holds the same rows
        // (constant indices only: an accumulator indexed at run time makes
        // ptxas serialize the wgmma pipeline)
        float* out = red + (size_t)(wg * 128 + idx) * kHalf;
        const float* in = red + (size_t)((wg ^ 1) * 128 + idx) * kHalf;
        float sum[kHalf];
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          out[i] = wg ? acc[0][i] : acc[0][kHalf + i];
          sum[i] = wg ? acc[0][kHalf + i] : acc[0][i];
        }
        named_barrier(2, kConsumerThreads);
#pragma unroll
        for (int i = 0; i < kHalf; ++i) sum[i] += in[i];
        named_barrier(2, kConsumerThreads);  // red is free again

        // gate backward: element (jj, hh, e) of sum is row rl[hh], unit
        // u0 + 8 (kKeep wg + jj) + col2 + e
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (!ok[hh]) continue;
          const size_t grow = ((size_t)t * batch + r0 + rl[hh]) * h4;
          const size_t crow = (size_t)(r0 + rl[hh]) * hidden;
          bf16* xrow = x_next + ((size_t)(r0 / kTileRows) * n_atoms *
                                     kTileRows + rl[hh]) * kTileK;
#pragma unroll
          for (int jj = 0; jj < G::kKeep; ++jj) {
            const int u = u0 + 8 * (G::kKeep * wg + jj) + col2;
            float dg[4][2], dcn[2];
            const float2 dyf = widen(dyv[hh][jj]);
            const float2 ct = __bfloat1622float2(c_t[hh][jj]);
            const float2 cp = __bfloat1622float2(c_p[hh][jj]);
            float gt[4][2];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const float2 v = __bfloat1622float2(gate[hh][jj][g]);
              gt[g][0] = v.x;
              gt[g][1] = v.y;
            }
            const float dyp[2] = {dyf.x, dyf.y};
            const float ctp[2] = {ct.x, ct.y};
            const float cpp[2] = {cp.x, cp.y};
            const float dcp[2] = {dc[hh][jj].x, dc[hh][jj].y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dh = dyp[e] + sum[4 * jj + 2 * hh + e];
              const float ig = sigmoid_f(gt[0][e]);
              const float fg = sigmoid_f(gt[1][e]);
              const float gg = tanhf(gt[2][e]);
              const float og = sigmoid_f(gt[3][e]);
              const float tc = tanhf(ctp[e]);
              const float d_o = dh * tc;
              const float dct = dcp[e] + dh * og * (1.0f - tc * tc);
              dg[0][e] = dct * gg * ig * (1.0f - ig);
              dg[1][e] = dct * cpp[e] * fg * (1.0f - fg);
              dg[2][e] = dct * ig * (1.0f - gg * gg);
              dg[3][e] = d_o * og * (1.0f - og);
              dcn[e] = dct * fg;
            }
            store2(dcbuf + crow + u, dcn[0], dcn[1]);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const int k = g * hidden + u;
              store2(dxg + grow + k, dg[g][0], dg[g][1]);
              // bf16(dgates) into the next step's operand, swizzled by row
              store2(xrow + (size_t)(k / kTileK) * kGAtom +
                         swizzled_chunk(rl[hh], (k % kTileK) / 8) * 8 +
                         (k % 8),
                     dg[g][0], dg[g][1]);
            }
          }
        }
      }
      // arrive at the grid barrier: the block's plain stores of dgates,
      // made visible to the other blocks' bulk copies, then one count
      fence_proxy_async();
      named_barrier(1, kConsumerThreads);
      if (tid == 0) {
        __threadfence();
        atomicAdd(step_counter, 1u);
      }
    }
  }
}

// w_h (H, 4H), f32 or bf16 -> the packed operand of the chunked kernel at
// padded H (`hp`) for tiles of U units: one thread per 16-byte chunk of the
// output, which it fills with the 8 values of w_h that the 128-byte swizzle
// puts there (rows, and units of each gate block, at and beyond `hidden`
// are zero).
template <typename W, int U>
__global__ void __launch_bounds__(256)
lstm_pack_chunked_bwd_kernel(const W* __restrict__ w_h, bf16* __restrict__ wp,
                             int hidden, int hp) {
  const int n_atoms = 4 * hp / kTileK;
  const size_t n_chunks = (size_t)hp * n_atoms * 8;
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n_chunks;
       i += (size_t)gridDim.x * 256) {
    // i = ((tile * n_atoms + atom) * U + j) * 8 + position
    const int pos = i % 8;
    const int j = (i / 8) % U;
    const size_t tile_atom = i / (8 * U);
    const int atom = tile_atom % n_atoms;
    const int row = (int)(tile_atom / n_atoms) * U + j;
    const int k0 = atom * kTileK + swizzled_chunk(j, pos) * 8;
    const int g = k0 / hp;
    const int unit0 = k0 - g * hp;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __float2bfloat16(
          row < hidden && unit0 + e < hidden
              ? to_f(w_h[(size_t)row * 4 * hidden + (size_t)g * hidden +
                         unit0 + e])
              : 0.0f);
    *reinterpret_cast<uint4*>(wp + i * 8) = *reinterpret_cast<const uint4*>(v);
  }
}

// One cooperative launch of the chunked kernel: every block must be
// co-resident, since the kernel's own grid barrier spins. Refused
// (cudaErrorCooperativeLaunchTooLarge) when the card cannot hold them all.
template <typename T, typename D, int U>
int launch_chunked(const void* gs, const void* wp, const void* cs,
                   const void* dy, void* dxg, void* xbuf, void* dcbuf,
                   void* step_counter, int n_steps, int batch, int hidden,
                   int tiles_per_block, int resident_ktiles, int reverse,
                   cudaStream_t stream) {
  using G = Tile<U>;
  const void* kernel = (const void*)lstm_bwd_chunked_kernel<T, D, U>;
  const int n_tiles = (hidden / U) * ((batch + kTileRows - 1) / kTileRows);
  const int grid = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const size_t smem =
      G::kFixedBytes +
      (size_t)tiles_per_block * resident_ktiles * G::kWTileBytes;
  void* args[] = {&gs,      &wp,    &cs,     &dy,
                  &dxg,     &xbuf,  &dcbuf,  &step_counter,
                  &n_steps, &batch, &hidden, &tiles_per_block,
                  &resident_ktiles, &reverse};
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kChunkedThreads, smem)) != cudaSuccess)
    return (int)err;
  if (grid > per_sm * n_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kChunkedThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename D, int U>
int launch_chunked_stream(const void* gs, const void* wp, const void* cs,
                          const void* dy, void* dxg, void* xbuf, void* dcbuf,
                          void* step_counter, int n_steps, int batch,
                          int hidden, int tiles_per_block,
                          int resident_ktiles, int reverse, int dy_bf16,
                          cudaStream_t stream) {
  if (dy_bf16)
    return launch_chunked<bf16, D, U>(gs, wp, cs, dy, dxg, xbuf, dcbuf,
                                      step_counter, n_steps, batch, hidden,
                                      tiles_per_block, resident_ktiles,
                                      reverse, stream);
  return launch_chunked<float, D, U>(gs, wp, cs, dy, dxg, xbuf, dcbuf,
                                     step_counter, n_steps, batch, hidden,
                                     tiles_per_block, resident_ktiles,
                                     reverse, stream);
}

template <int U>
int launch_pack(const void* w_h, void* wp, int hidden, int hp, int w_bf16,
                cudaStream_t stream) {
  const int grid = 132 * 8;  // a grid-stride loop over the chunks
  if (w_bf16)
    lstm_pack_chunked_bwd_kernel<bf16, U><<<grid, 256, 0, stream>>>(
        static_cast<const bf16*>(w_h), static_cast<bf16*>(wp), hidden, hp);
  else
    lstm_pack_chunked_bwd_kernel<float, U><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(w_h), static_cast<bf16*>(wp), hidden, hp);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return a cudaError_t code (0 on success). All pointers come from fresh
// PyTorch allocations (256-byte aligned). `units` is the tile's hidden units.
//
// lstm_pack_chunked_bwd: w_h (hidden, 4*hidden), f32 (w_bf16 = 0) or bf16
// -> wp (hp/units, 4*hp/64, units, 64) bf16, hp >= hidden a multiple of 32.
extern "C" int lstm_pack_chunked_bwd(const void* w_h, void* wp, int hidden,
                                     int hp, int units, int w_bf16,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden < 1 || hp < hidden || hp % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (units == 32) return launch_pack<32>(w_h, wp, hidden, hp, w_bf16, st);
  if (units == 16) return launch_pack<16>(w_h, wp, hidden, hp, w_bf16, st);
  return (int)cudaErrorInvalidValue;
}

// lstm_bwd_chunked: wp, xbuf, step_counter as at lstm_bwd_chunked_kernel;
// dy_bf16 selects the dtype of dy (1: bf16, 0: f32); the two forms built
// are K6b's (dxg_bf16 = 0: f32 dxg, units = 32) and K5b's (dxg_bf16 = 1:
// bf16 dxg, units = 16); `hidden` a multiple of 32 (the
// wrapper pads); tiles_per_block * resident_ktiles k-tiles of units / 4 KB
// must fit the block's shared memory beside Tile<units>::kFixedBytes. A grid
// the card cannot hold co-resident is refused.
extern "C" int lstm_bwd_chunked(const void* gs, const void* wp,
                                const void* cs, const void* dy, void* dxg,
                                void* xbuf, void* dcbuf, void* step_counter,
                                int n_steps, int batch, int hidden,
                                int tiles_per_block, int resident_ktiles,
                                int reverse, int units, int dy_bf16,
                                int dxg_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden < 32 || hidden % 32 != 0 || hidden % units != 0 ||
      n_steps < 1 || batch < 1 || tiles_per_block < 1 ||
      resident_ktiles < 0 || resident_ktiles > 4 * hidden / kKTile)
    return (int)cudaErrorInvalidValue;
#define LSTM_BWD_CASE(D, UV)                                                \
  return launch_chunked_stream<D, UV>(gs, wp, cs, dy, dxg, xbuf, dcbuf,    \
                                      step_counter, n_steps, batch, hidden, \
                                      tiles_per_block, resident_ktiles,    \
                                      reverse, dy_bf16, st)
  if (!dxg_bf16 && units == 32) LSTM_BWD_CASE(float, 32);
  if (dxg_bf16 && units == 16) LSTM_BWD_CASE(bf16, 16);
#undef LSTM_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
