// Shared body of the GRU and light-GRU recurrence kernels for Hopper
// (gru.cu, ligru.cu): a gated recurrence with NG gate blocks per hidden unit
// (GRU r,z,n: 3; liGRU z,a: 2), forward and backward, whose cell arithmetic
// comes from a Cell policy.
//
// Design. These recurrences run in the listener, at a small batch (16 or 8
// rows) and a long sequence (T = 400), so a step is latency, not throughput:
// T dependent steps, each a (B x H) @ (H x NG*H) product followed by a few
// activations. Each walk is one persistent cooperative launch with a grid
// barrier per step, every block owning a tile of hidden units for the whole
// walk: its slab of w_h stays in shared memory (forward: the NG gate columns
// of its units, packed k-contiguous; backward: its rows of w_h,
// contiguous as they are), its cells' f32 carries are touched by it alone,
// and bf16(h) (forward) or bf16(dhg) (backward) is exchanged between blocks
// through a double-buffered global buffer that the next step reads from L2.
//
// The batch gives one m16 tile per pass, too few rows to occupy eight warps
// by output tiles, so the product is split over k instead: the A rows are
// streamed from L2 in segments of kSeg k-values through a cp.async ring, the
// warps of a k group take its k16 steps of each segment against their
// n-tiles of the slab (mma.sync m16n8k16 bf16, f32 sums, fragments read with
// ldmatrix from rows padded by 16 bytes), and the partial (16 x NC)
// products meet in shared memory, where the thread that owns a cell (row,
// unit) sums them and updates it. Batches above 16 take further passes of
// 16 rows.
//
// The forward has two forms (the wrappers' rule, ops/kernels/gru.py
// `form_for`):
//   packed  both directions of a bidirectional layer in ONE launch, as the
//           BLSTM forward K1 walks them (bilstm_fwd.cu): blocks 0 .. H/20-1
//           take the forward direction (t = s), the others the backward one
//           (t = T-1-s), 20 units a block, 128 blocks at H = 1280, one grid
//           barrier a step for both. The slab is the NG*20 gate columns
//           padded to whole n-tiles (GRU: 60 -> 64, 8 n-tiles, split over
//           the warps 4 ways by k and 2 by n; light GRU: 40, 5 n-tiles, a
//           k group a warp), the ring 3 segments deep, and the partial
//           tiles are written over the ring once every warp has read it.
//   single  one direction a launch, 16 units a block (H/16 blocks), a k
//           group a warp against all NG*16 columns, a 4-deep ring and a
//           partials buffer of its own: a unidirectional layer, and an H
//           whose packed grid or slab the card cannot hold.
// The backward has two forms, picked by the same rule (`form_for(...,
// backward=True)`):
//   packed  both directions' backward in ONE launch, as the BLSTM backward
//           K2 walks them (bilstm_bwd.cu, its resident form): blocks 0 ..
//           H/20-1 walk the forward direction (t = T-1-s), the others the
//           backward one (t = s), one grid barrier a step for both. A block
//           keeps its 20 rows of w_h, contiguous in the (H, NG*H) layout, in
//           shared memory (GRU 20 x (3H+8) bf16, 154 KB at H = 1280; light
//           GRU 103 KB), streams the previous step's bf16(dhh) rows through
//           a 4-deep cp.async ring of 512-wide segments (half the block
//           barriers a step of K2's 256-wide ones), and takes them against
//           the slab as three n-tiles, each warp a k group of its own, the
//           partial tiles written over the ring.
//   single  one direction a launch at 16 units a block.
//
// Bound on the H100. Per step the grid reads bf16(h) once per block from L2
// (H=1280, B=16: 128 blocks x 40 KB packed) and does 2*B*H*NG*H operations a
// direction, both far below what the card can do in the few us a step
// takes: the time is the chain cp.async -> mma -> shared-memory reduction ->
// activations -> grid barrier, T times. PERF.md has the measured times.

#pragma once

#include "lstm_common.cuh"

namespace rec {

using namespace lstm;

constexpr int kUT = 16;            // hidden units per block (single form)
constexpr int kRows = 16;          // batch rows per pass: one m16 tile
constexpr int kSeg = 256;          // k values per staged segment
constexpr int kLda = kSeg + 8;     // padded row stride of a staged segment
constexpr int kRing = 4;           // cp.async ring depth
constexpr int kRingElems = kRing * kRows * kLda;

inline size_t fwd_smem_bytes(int n_gates, int hidden) {
  const size_t nc = (size_t)n_gates * kUT;
  return sizeof(bf16) * (nc * (hidden + 8) + kRingElems) +
         sizeof(float) * kWarps * kRows * nc;
}
inline size_t bwd_smem_bytes(int n_gates, int hidden) {
  return sizeof(bf16) * ((size_t)kUT * (n_gates * hidden + 8) + kRingElems) +
         sizeof(float) * kWarps * kRows * kUT;
}

// part[w][row][0..NT*8) = the partial product of warp w's k16 steps of
//     A[rows, K] * Wt[NT*8, K]^T         (A bf16 in global, Wt in shared)
// for one pass of up to kRows rows. Rows of A at and beyond nrows are not
// loaded: their products are garbage that no thread reads. Ends with the
// partials visible to every thread of the block.
template <int NT>
__device__ __forceinline__ void splitk_product(const bf16* a_g, size_t lda,
                                               int nrows, int K,
                                               const bf16* w_res, int ldw,
                                               bf16* ring, float* part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int nseg = (K + kSeg - 1) / kSeg;
  auto fetch = [&](int c) {
    const int k0 = c * kSeg;
    const int ppr = min(kSeg, K - k0) >> 3;  // 16-byte pieces per row
    bf16* dst = ring + (c % kRing) * kRows * kLda;
    for (int i = threadIdx.x; i < nrows * ppr; i += kThreads) {
      const int r = i / ppr;
      const int p = i - r * ppr;
      cp_async16(dst + r * kLda + p * 8, a_g + (size_t)r * lda + k0 + p * 8);
    }
  };
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < nseg) fetch(c);
    cp_async_commit();
  }
  for (int c = 0; c < nseg; ++c) {
    cp_async_wait<kRing - 2>();  // this thread's copies of segment c landed
    __syncthreads();  // everyone's did, and segment c-1's buffer is free
    if (c + kRing - 1 < nseg) fetch(c + kRing - 1);
    cp_async_commit();
    const int k0 = c * kSeg;
    const int ksteps = min(kSeg, K - k0) >> 4;
    const bf16* a_st = ring + (c % kRing) * kRows * kLda;
    for (int ks = warp; ks < ksteps; ks += kWarps) {
      const int kk = ks * 16;
      uint32_t a[4];  // lane l addresses row l%16, k half l/16
      ldmatrix_x4(a, a_st + (lane & 15) * kLda + kk + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        // n-tiles 2p and 2p+1: lane l addresses row l%8 of n-tile
        // 2p + l/16, k half (l/8)%2
        const int nrow = (2 * p + (lane >> 4)) * 8 + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4(b, w_res + (size_t)nrow * ldw + k0 + kk +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  // element e of n-tile n is (row lane/4 + 8*(e/2), col 8n + 2*(lane%4) + e%2)
  constexpr int NC = NT * 8;
  float* mine = part + (size_t)warp * kRows * NC;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (lane >> 2) + 8 * half;
      *reinterpret_cast<float2*>(mine + row * NC + n * 8 + 2 * (lane & 3)) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float sum_partials(const float* part, int nc,
                                              int row, int col) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[((size_t)w * kRows + row) * nc + col];
  return s;
}

// Forward walk. Cell::NG gate blocks; Cell::forward(x, hg, h_prev, mask)
// gives the new h from the cell's NG input pre-activations x (f32 from the
// stream), its NG recurrent terms hg (f32 sums, bias added) and the f32
// carry.
//   xg    (T,B,NG*H) in T, data order          ys   (T,B,H) in T
//   wp    (H/16, NG*16, H) bf16: per tile, row g*16 + j holds the H weights
//         of gate g of unit 16*tile + j (column g*H + 16*tile + j of w_h)
//   bias  (NG*H) f32 added to hg, or null      mask (B,H) f32, or null
//   hgs   (T,B,NG*H) bf16 stash of hg, or null to skip it
//   hbuf  (2,B,H) bf16, buffer 0 zeroed        hcar (B,H) f32, zeroed
template <typename T, typename Cell>
__device__ __forceinline__ void rec_fwd_body(
    const T* __restrict__ xg, const bf16* __restrict__ wp,
    const float* __restrict__ bias, const float* __restrict__ mask, T* ys,
    bf16* hgs, bf16* hbuf, float* hcar, int n_steps, int batch, int hidden,
    int reverse) {
  constexpr int NG = Cell::NG;
  constexpr int NC = NG * kUT;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_res = reinterpret_cast<bf16*>(smem_raw);
  const int ldw = hidden + 8;
  bf16* ring = w_res + (size_t)NC * ldw;
  float* part = reinterpret_cast<float*>(ring + kRingElems);
  const int row = threadIdx.x >> 4;  // the thread's cell: (row, unit j)
  const int j = threadIdx.x & 15;
  const int u = blockIdx.x * kUT + j;
  const size_t bh = (size_t)batch * hidden;
  const size_t gh = (size_t)NG * hidden;

  for (int i = threadIdx.x; i < kRingElems; i += kThreads)
    ring[i] = __float2bfloat16(0.0f);
  load_resident(w_res, wp + (size_t)blockIdx.x * NC * hidden, hidden, NC,
                hidden);
  float bj[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g)
    bj[g] = bias != nullptr ? bias[(size_t)g * hidden + u] : 0.0f;

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const bf16* h_prev = hbuf + (size_t)(s & 1) * bh;
    bf16* h_next = hbuf + (size_t)((s & 1) ^ 1) * bh;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int nr = min(kRows, batch - r0);
      const bool live = row < nr;
      const size_t bu = (size_t)(r0 + row) * hidden + u;
      const size_t xrow = ((size_t)t * batch + r0 + row) * gh + u;
      // the cell's global loads start ahead of the product
      float x[NG], hp = 0.0f, mk = 1.0f;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        x[g] = live ? to_f(xg[xrow + (size_t)g * hidden]) : 0.0f;
      if (live) {
        hp = hcar[bu];
        if (mask != nullptr) mk = mask[bu];
      }
      splitk_product<NC / 8>(h_prev + (size_t)r0 * hidden, hidden, nr, hidden,
                             w_res, ldw, ring, part);
      if (live) {
        float hg[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          hg[g] = sum_partials(part, NC, row, g * kUT + j) + bj[g];
        const float h_new = Cell::forward(x, hg, hp, mk);
        hcar[bu] = h_new;
        h_next[bu] = __float2bfloat16(h_new);
        put(ys + (size_t)t * bh + bu, h_new);
        if (hgs != nullptr) {
#pragma unroll
          for (int g = 0; g < NG; ++g)
            hgs[xrow + (size_t)g * hidden] = __float2bfloat16(hg[g]);
        }
      }
      __syncthreads();  // the partials are free for the next pass
    }
    grid.sync();
  }
}

// Backward walk: the forward's order walked backwards from its bf16 stash
// hgs and the bf16 hidden stream ys (h_prev is ys one scan step earlier,
// zero at the scan's start). Per step
//     dh = dy[t] + (dh_prev * z_prev + bf16(dhg_prev) @ bf16(w_h)^T)
// and Cell::backward(x, hg, h_prev, mask, dh, dx, dhh) gives the cotangents
// dx of the input pre-activations and dhh of the recurrent terms and returns
// z, the share of dh that the carry passes on.
//   wh    (H, NG*H) bf16, as it is             dy   (T,B,H) in T
//   dxg   (T,B,NG*H) in T                      dhg  (T,B,NG*H) f32, or null
//   xbuf  (2,B,NG*H) bf16 exchange of bf16(dhh), rounded from the f32 value
//   dhz   (B,H) f32, zeroed: dh * z of the previous step
template <typename T, typename Cell>
__device__ __forceinline__ void rec_bwd_body(
    const T* __restrict__ xg, const bf16* __restrict__ wh,
    const float* __restrict__ mask, const bf16* __restrict__ hgs,
    const bf16* __restrict__ ys, const T* __restrict__ dy, T* dxg, float* dhg,
    bf16* xbuf, float* dhz, int n_steps, int batch, int hidden, int reverse) {
  constexpr int NG = Cell::NG;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_res = reinterpret_cast<bf16*>(smem_raw);
  const int k_all = NG * hidden;
  const int ldw = k_all + 8;
  bf16* ring = w_res + (size_t)kUT * ldw;
  float* part = reinterpret_cast<float*>(ring + kRingElems);
  const int row = threadIdx.x >> 4;
  const int j = threadIdx.x & 15;
  const int u = blockIdx.x * kUT + j;
  const size_t bh = (size_t)batch * hidden;
  const size_t gh = (size_t)k_all;

  for (int i = threadIdx.x; i < kRingElems; i += kThreads)
    ring[i] = __float2bfloat16(0.0f);
  load_resident(w_res, wh + (size_t)blockIdx.x * kUT * gh, gh, kUT, k_all);

  for (int s = 0; s < n_steps; ++s) {
    // a plain forward is walked T-1..0, a reversed one 0..T-1
    const int t = reverse ? s : n_steps - 1 - s;
    const int t_cp = reverse ? t + 1 : t - 1;  // forward-scan predecessor
    const bool has_cp = t_cp >= 0 && t_cp < n_steps;
    const bf16* a_all = xbuf + (size_t)(s & 1) * batch * gh;
    bf16* x_next = xbuf + (size_t)((s & 1) ^ 1) * batch * gh;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int nr = min(kRows, batch - r0);
      const bool live = row < nr;
      const size_t bu = (size_t)(r0 + row) * hidden + u;
      const size_t xrow = ((size_t)t * batch + r0 + row) * gh + u;
      float x[NG], hg[NG], hp = 0.0f, dyv = 0.0f, carry = 0.0f, mk = 1.0f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        x[g] = live ? to_f(xg[xrow + (size_t)g * hidden]) : 0.0f;
        hg[g] = live ? __bfloat162float(hgs[xrow + (size_t)g * hidden]) : 0.0f;
      }
      if (live) {
        if (has_cp) hp = __bfloat162float(ys[(size_t)t_cp * bh + bu]);
        dyv = to_f(dy[(size_t)t * bh + bu]);
        carry = dhz[bu];
        if (mask != nullptr) mk = mask[bu];
      }
      if (s > 0)
        splitk_product<kUT / 8>(a_all + (size_t)r0 * gh, gh, nr, k_all, w_res,
                                ldw, ring, part);
      if (live) {
        const float prod = s > 0 ? sum_partials(part, kUT, row, j) : 0.0f;
        const float dh = dyv + (carry + prod);
        float dx[NG], dhh[NG];
        const float z = Cell::backward(x, hg, hp, mk, dh, dx, dhh);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          put(dxg + xrow + (size_t)g * hidden, dx[g]);
          if (dhg != nullptr) dhg[xrow + (size_t)g * hidden] = dhh[g];
          x_next[(size_t)(r0 + row) * gh + (size_t)g * hidden + u] =
              __float2bfloat16(dhh[g]);
        }
        dhz[bu] = dh * z;
      }
      __syncthreads();  // the partials are free for the next pass
    }
    grid.sync();
  }
}

template <typename T, typename Cell>
__global__ void __launch_bounds__(kThreads)
rec_fwd_kernel(const T* xg, const bf16* wp, const float* bias,
               const float* mask, T* ys, bf16* hgs, bf16* hbuf, float* hcar,
               int n_steps, int batch, int hidden, int reverse) {
  rec_fwd_body<T, Cell>(xg, wp, bias, mask, ys, hgs, hbuf, hcar, n_steps,
                        batch, hidden, reverse);
}

template <typename T, typename Cell>
__global__ void __launch_bounds__(kThreads)
rec_bwd_kernel(const T* xg, const bf16* wh, const float* mask,
               const bf16* hgs, const bf16* ys, const T* dy, T* dxg,
               float* dhg, bf16* xbuf, float* dhz, int n_steps, int batch,
               int hidden, int reverse) {
  rec_bwd_body<T, Cell>(xg, wh, mask, hgs, ys, dy, dxg, dhg, xbuf, dhz,
                        n_steps, batch, hidden, reverse);
}

// ---- the direction-packed forward form ------------------------------------
// A block owns kPkUnits units of one direction; a launch holds both
// directions, so the padded H must be a multiple of 80 (the tile and an mma
// k step).
constexpr int kPkUnits = 20;
constexpr int kPkRing = 3;  // cp.async ring depth
constexpr int kPkRingElems = kPkRing * kRows * kLda;

template <int NG, int U>
struct PackTile {
  static constexpr int kCols = (NG * U + 7) / 8 * 8;  // gate columns, padded
  static constexpr int kNT = kCols / 8;                // n-tiles of the slab
  static constexpr int kNSplit = kNT >= 8 ? 2 : 1;     // warps sharing k
  static constexpr int kNTW = kNT / kNSplit;           // n-tiles a warp
  static constexpr int kKGroups = kWarps / kNSplit;
  static_assert(kNT % kNSplit == 0, "whole n-tiles a warp");
  static_assert(sizeof(bf16) * kPkRingElems >=
                    sizeof(float) * kKGroups * kRows * kCols,
                "the partial tiles overlay the ring");
};

template <int NG, int U>
inline size_t packed_smem_bytes(int hidden) {
  return sizeof(bf16) *
         ((size_t)PackTile<NG, U>::kCols * (hidden + 8) + kPkRingElems);
}

// part[g][row][0..kCols) = the partial product of k group g of
//     A[rows, K] * Wt[kCols, K]^T        (A bf16 in global, Wt in shared)
// for one pass of up to kRows rows: warp w takes k group w / kNSplit and the
// kNTW n-tiles from kNTW * (w % kNSplit) on. The partials are written over
// the ring once every warp has read its last segment.
template <int NG, int U>
__device__ __forceinline__ void packed_product(const bf16* a_g, size_t lda,
                                               int nrows, int K,
                                               const bf16* w_res, int ldw,
                                               bf16* ring, float* part) {
  using P = PackTile<NG, U>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // shift and mask, not division: the compiler then bounds the k loop's
  // trip count and unrolls it (a division cost K1 17%)
  const int kg = warp >> (P::kNSplit - 1);
  const int n0 = (warp & (P::kNSplit - 1)) * P::kNTW;
  float acc[P::kNTW][4];
#pragma unroll
  for (int n = 0; n < P::kNTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int nseg = (K + kSeg - 1) / kSeg;
  auto fetch = [&](int c) {
    const int k0 = c * kSeg;
    const int ppr = min(kSeg, K - k0) >> 3;  // 16-byte pieces per row
    bf16* dst = ring + (c % kPkRing) * kRows * kLda;
    for (int i = threadIdx.x; i < nrows * ppr; i += kThreads) {
      const int r = i / ppr;
      const int p = i - r * ppr;
      cp_async16(dst + r * kLda + p * 8, a_g + (size_t)r * lda + k0 + p * 8);
    }
  };
  for (int c = 0; c < kPkRing - 1; ++c) {
    if (c < nseg) fetch(c);
    cp_async_commit();
  }
  for (int c = 0; c < nseg; ++c) {
    cp_async_wait<kPkRing - 2>();
    __syncthreads();  // segment c landed for all, segment c-1's buffer free
    if (c + kPkRing - 1 < nseg) fetch(c + kPkRing - 1);
    cp_async_commit();
    const int k0 = c * kSeg;
    const int ksteps = min(kSeg, K - k0) >> 4;
    const bf16* a_st = ring + (c % kPkRing) * kRows * kLda;
    for (int ks = kg; ks < ksteps; ks += P::kKGroups) {
      const int kk = ks * 16;
      uint32_t a[4];  // lane l addresses row l%16, k half l/16
      ldmatrix_x4(a, a_st + (lane & 15) * kLda + kk + (lane >> 4) * 8);
      const bf16* w_k = w_res + k0 + kk + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < P::kNTW / 2; ++p) {
        // n-tiles n0 + 2p and n0 + 2p + 1: lane l addresses row l%8 of
        // n-tile n0 + 2p + l/16, k half (l/8)%2
        const int nrow = (n0 + 2 * p + (lane >> 4)) * 8 + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4(b, w_k + (size_t)nrow * ldw);
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
      if constexpr (P::kNTW % 2 == 1) {
        // the last n-tile: lanes 0-15 address, 16-31 repeat them
        uint32_t b2[2];
        ldmatrix_x2(b2, w_k + (size_t)((n0 + P::kNTW - 1) * 8 + (lane & 7)) *
                                  ldw);
        mma_bf16(acc[P::kNTW - 1], a, b2[0], b2[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp has read the ring: it becomes the partials
  float* mine = part + (size_t)kg * kRows * P::kCols;
#pragma unroll
  for (int n = 0; n < P::kNTW; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (lane >> 2) + 8 * half;
      *reinterpret_cast<float2*>(mine + row * P::kCols + (n0 + n) * 8 +
                                 2 * (lane & 3)) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
  __syncthreads();
}

// Both directions' forward walks in one launch. Blocks 0 .. H/U - 1 walk the
// forward direction (t = s), the others the backward one (t = T-1-s); each
// direction has its own xg, ys and stash, its own half of wp, bias and the
// exchange buffers, and the mask is shared.
//   xg_*  (T,B,NG*H) in T, data order          ys_* (T,B,H) in T
//   wp    (2, H/U, kCols, H) bf16: per direction and tile, row g*U + j holds
//         the H weights of gate g of unit U*tile + j (column g*H + U*tile + j
//         of that direction's w_h); rows NG*U .. kCols-1 are zero
//   bias  (2, NG*H) f32 added to hg, or null   mask (B,H) f32, or null
//   hgs_* (T,B,NG*H) bf16 stash of hg, or null to skip it
//   hbuf  (2 directions, 2, B, H) bf16, each buffer 0 zeroed
//   hcar  (2 directions, B, H) f32, zeroed
template <typename T, typename Cell, int U>
__global__ void __launch_bounds__(kThreads)
rec_packed_fwd_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                      const bf16* __restrict__ wp,
                      const float* __restrict__ bias,
                      const float* __restrict__ mask, T* ys_f, T* ys_b,
                      bf16* hgs_f, bf16* hgs_b, bf16* hbuf, float* hcar,
                      int n_steps, int batch, int hidden) {
  constexpr int NG = Cell::NG;
  using P = PackTile<NG, U>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char packed_smem[];
  bf16* w_res = reinterpret_cast<bf16*>(packed_smem);
  const int ldw = hidden + 8;
  bf16* ring = w_res + (size_t)P::kCols * ldw;
  float* part = reinterpret_cast<float*>(ring);
  const int tiles_per_dir = hidden / U;
  const int dir = blockIdx.x >= tiles_per_dir;
  const int u0 = (blockIdx.x - dir * tiles_per_dir) * U;
  const size_t bh = (size_t)batch * hidden;
  const size_t gh = (size_t)NG * hidden;
  const T* xg = dir ? xg_b : xg_f;
  T* ys = dir ? ys_b : ys_f;
  bf16* hgs = dir ? hgs_b : hgs_f;
  bf16* hdir = hbuf + (size_t)dir * 2 * bh;
  float* car = hcar + (size_t)dir * bh;
  // the thread's cells of a 16-row pass
  int rows[2], units[2];
  const int n_mine = pass_cells<U>(threadIdx.x, rows, units);
  float bj[2][NG];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      bj[q][g] = bias != nullptr && q < n_mine
                     ? bias[dir * gh + (size_t)g * hidden + u0 + units[q]]
                     : 0.0f;

  for (int i = threadIdx.x; i < kPkRingElems; i += kThreads)
    ring[i] = __float2bfloat16(0.0f);
  load_resident(w_res, wp + (size_t)blockIdx.x * P::kCols * hidden, hidden,
                P::kCols, hidden);

  for (int s = 0; s < n_steps; ++s) {
    const int t = dir ? n_steps - 1 - s : s;
    const bf16* h_prev = hdir + (size_t)(s & 1) * bh;
    bf16* h_next = hdir + (size_t)((s & 1) ^ 1) * bh;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int nr = min(kRows, batch - r0);
      // the cells' global loads start ahead of the product
      float x[2][NG], hp[2], mk[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool live = q < n_mine && rows[q] < nr;
        const size_t bu = (size_t)(r0 + rows[q]) * hidden + u0 + units[q];
        const size_t xrow =
            ((size_t)t * batch + r0 + rows[q]) * gh + u0 + units[q];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          x[q][g] = live ? to_f(xg[xrow + (size_t)g * hidden]) : 0.0f;
        hp[q] = live ? car[bu] : 0.0f;
        mk[q] = live && mask != nullptr ? mask[bu] : 1.0f;
      }
      packed_product<NG, U>(h_prev + (size_t)r0 * hidden, hidden, nr, hidden,
                            w_res, ldw, ring, part);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= n_mine || rows[q] >= nr) continue;
        const size_t bu = (size_t)(r0 + rows[q]) * hidden + u0 + units[q];
        const size_t xrow =
            ((size_t)t * batch + r0 + rows[q]) * gh + u0 + units[q];
        float hg[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float sum = 0.0f;
#pragma unroll
          for (int k = 0; k < P::kKGroups; ++k)
            sum += part[((size_t)k * kRows + rows[q]) * P::kCols + g * U +
                        units[q]];
          hg[g] = sum + bj[q][g];
        }
        const float h_new = Cell::forward(x[q], hg, hp[q], mk[q]);
        car[bu] = h_new;
        h_next[bu] = __float2bfloat16(h_new);
        put(ys + (size_t)t * bh + bu, h_new);
        if (hgs != nullptr) {
#pragma unroll
          for (int g = 0; g < NG; ++g)
            hgs[xrow + (size_t)g * hidden] = __float2bfloat16(hg[g]);
        }
      }
      __syncthreads();  // the partials become the ring again
    }
    grid.sync();
  }
}

// Both directions, kPkUnits units a block: 2 * H/20 blocks, every one
// resident; the launch is refused when the card cannot hold them.
template <typename T, typename Cell>
int launch_packed_fwd(const void* xg_f, const void* xg_b, const void* wp,
                      const void* bias, const void* mask, void* ys_f,
                      void* ys_b, void* hgs_f, void* hgs_b, void* hbuf,
                      void* hcar, int n_steps, int batch, int hidden,
                      cudaStream_t stream) {
  if (hidden < 80 || hidden % 80 != 0 || n_steps < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&xg_f, &xg_b, &wp, &bias, &mask, &ys_f, &ys_b,
                  &hgs_f, &hgs_b, &hbuf, &hcar, &n_steps, &batch, &hidden};
  return coop_launch(
      (const void*)rec_packed_fwd_kernel<T, Cell, kPkUnits>,
      packed_smem_bytes<Cell::NG, kPkUnits>(hidden), 2 * (hidden / kPkUnits),
      true, args, stream);
}

inline bool bad_shape(int n_steps, int batch, int hidden) {
  return hidden < kUT || hidden % kUT != 0 || n_steps < 1 || batch < 1;
}

// The single form: one direction, one tile of 16 units per block, every
// block resident; the launch is refused when the card cannot hold H/16
// blocks of this much shared memory.
template <typename T, typename Cell>
int launch_fwd(const void* xg, const void* wp, const void* bias,
               const void* mask, void* ys, void* hgs, void* hbuf, void* hcar,
               int n_steps, int batch, int hidden, int reverse,
               cudaStream_t stream) {
  if (bad_shape(n_steps, batch, hidden)) return (int)cudaErrorInvalidValue;
  void* args[] = {&xg, &wp, &bias, &mask, &ys, &hgs, &hbuf, &hcar,
                  &n_steps, &batch, &hidden, &reverse};
  return coop_launch((const void*)rec_fwd_kernel<T, Cell>,
                     fwd_smem_bytes(Cell::NG, hidden), hidden / kUT, true,
                     args, stream);
}

template <typename T, typename Cell>
int launch_bwd(const void* xg, const void* wh, const void* mask,
               const void* hgs, const void* ys, const void* dy, void* dxg,
               void* dhg, void* xbuf, void* dhz, int n_steps, int batch,
               int hidden, int reverse, cudaStream_t stream) {
  if (bad_shape(n_steps, batch, hidden)) return (int)cudaErrorInvalidValue;
  void* args[] = {&xg, &wh, &mask, &hgs, &ys, &dy, &dxg, &dhg, &xbuf, &dhz,
                  &n_steps, &batch, &hidden, &reverse};
  return coop_launch((const void*)rec_bwd_kernel<T, Cell>,
                     bwd_smem_bytes(Cell::NG, hidden), hidden / kUT, true,
                     args, stream);
}

// ---- the direction-packed backward form -----------------------------------
// A block owns kPkUnits units of one direction, as the packed forward; its
// slab is their kPkUnits rows of w_h as they are, against which the product
// runs as three n-tiles of 8 (units 16-19 in the third, whose last four
// columns repeat row 19 of the slab and are read by no thread).
constexpr int kPbNT = 3;
constexpr int kPbCols = 8 * kPbNT;
constexpr int kPbSeg = 512;            // k values per staged segment
constexpr int kPbLda = kPbSeg + 8;     // padded row stride of a segment
constexpr int kPbRing = 4;             // cp.async ring depth
constexpr int kPbRingElems = kPbRing * kRows * kPbLda;
static_assert((kPbSeg & (kPbSeg - 1)) == 0, "a power of two");
static_assert(sizeof(bf16) * kPbRingElems >=
                  sizeof(float) * kWarps * kRows * kPbCols,
              "the partial tiles overlay the ring");

inline size_t packed_bwd_smem_bytes(int n_gates, int hidden) {
  return sizeof(bf16) *
         ((size_t)kPkUnits * (n_gates * hidden + 8) + kPbRingElems);
}

// part[w][row][0..kPbCols) = warp w's partial product over its k16 steps
// (w, w+8, ... of each segment) of
//     A[rows, K] * Wt[kPbCols, K]^T   (A bf16 in global, Wt the slab in shared)
// for one pass of up to kRows rows, where rows kPkUnits.. of Wt repeat its
// last row. The partials are written over the ring once every warp has read
// its last segment, and are visible to every thread on return.
__device__ __forceinline__ void packed_bwd_product(const bf16* a_g,
                                                   size_t lda, int nrows,
                                                   int K, const bf16* w_res,
                                                   int ldw, bf16* ring,
                                                   float* part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc[kPbNT][4];
#pragma unroll
  for (int n = 0; n < kPbNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // B fragments: n-tiles 0 and 1 in one ldmatrix_x4 (lane l addresses row
  // l%8 of n-tile l/16, k half (l/8)%2), n-tile 2 in an ldmatrix_x2 (lanes
  // 0-15 address rows 16 + l%8, clamped to the slab's last row)
  const int khalf = ((lane >> 3) & 1) * 8;
  const bf16* w01 =
      w_res + (size_t)((lane >> 4) * 8 + (lane & 7)) * ldw + khalf;
  const bf16* w2 =
      w_res + (size_t)min(16 + (lane & 7), kPkUnits - 1) * ldw + khalf;

  constexpr int kPieces = kPbSeg >> 3;  // 16-byte pieces of a full row
  const int nseg = (K + kPbSeg - 1) / kPbSeg;
  auto fetch = [&](int c) {
    const int k0 = c * kPbSeg;
    const int ppr = min(kPbSeg, K - k0) >> 3;
    bf16* dst = ring + (c % kPbRing) * kRows * kPbLda;
    // piece p of row r is i = r * kPieces + p; kPieces is a power of two,
    // so this is a shift and a mask, not a division by a run-time count
    for (int i = threadIdx.x; i < nrows * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int p = i & (kPieces - 1);
      if (p < ppr)
        cp_async16(dst + r * kPbLda + p * 8, a_g + (size_t)r * lda + k0 + p * 8);
    }
  };
  for (int c = 0; c < kPbRing - 1; ++c) {
    if (c < nseg) fetch(c);
    cp_async_commit();
  }
  for (int c = 0; c < nseg; ++c) {
    cp_async_wait<kPbRing - 2>();
    __syncthreads();  // segment c landed for all, segment c-1's buffer free
    if (c + kPbRing - 1 < nseg) fetch(c + kPbRing - 1);
    cp_async_commit();
    const int k0 = c * kPbSeg;
    const int ksteps = min(kPbSeg, K - k0) >> 4;
    const bf16* a_st = ring + (c % kPbRing) * kRows * kPbLda;
    for (int ks = warp; ks < ksteps; ks += kWarps) {
      const int kk = ks * 16;
      uint32_t a[4];  // lane l addresses row l%16, k half l/16
      ldmatrix_x4(a, a_st + (lane & 15) * kPbLda + kk + (lane >> 4) * 8);
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
  float* mine = part + (size_t)warp * kRows * kPbCols;
#pragma unroll
  for (int n = 0; n < kPbNT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (lane >> 2) + 8 * half;
      *reinterpret_cast<float2*>(mine + row * kPbCols + n * 8 +
                                 2 * (lane & 3)) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
  __syncthreads();
}

// Both directions' backward walks in one launch, each as rec_bwd_body walks
// one: blocks 0 .. H/U - 1 walk the forward direction (its forward scan
// backwards, t = T-1..0), the others the backward one (t = 0..T-1). Each
// direction has its own streams, w_h, stash and outputs, its half of the
// exchange buffer and of the dh*z carry; the mask is shared. Each warp
// takes the k16 steps the single form's does and the partial sums are added
// in its order, so at an H both forms pad alike (a multiple of 80) each
// direction's outputs are the single form's bit for bit.
//   xg_*  (T,B,NG*H) in T                        wh_* (H, NG*H) bf16
//   mask  (B,H) f32, or null                     hgs_* (T,B,NG*H) bf16
//   ys_*  (T,B,H) bf16                           dy_* (T,B,H) in T
//   dxg_* (T,B,NG*H) in T                        dhg_* (T,B,NG*H) f32, or null
//   xbuf  (2 directions, 2, B, NG*H) bf16        dhz  (2 directions, B, H) f32,
//                                                zeroed
template <typename T, typename Cell>
__global__ void __launch_bounds__(kThreads)
rec_packed_bwd_kernel(const T* __restrict__ xg_f, const T* __restrict__ xg_b,
                      const bf16* __restrict__ wh_f,
                      const bf16* __restrict__ wh_b,
                      const float* __restrict__ mask,
                      const bf16* __restrict__ hgs_f,
                      const bf16* __restrict__ hgs_b,
                      const bf16* __restrict__ ys_f,
                      const bf16* __restrict__ ys_b,
                      const T* __restrict__ dy_f, const T* __restrict__ dy_b,
                      T* dxg_f, T* dxg_b, float* dhg_f, float* dhg_b,
                      bf16* xbuf, float* dhz, int n_steps, int batch,
                      int hidden) {
  constexpr int NG = Cell::NG;
  constexpr int U = kPkUnits;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char packed_bwd_smem[];
  bf16* w_res = reinterpret_cast<bf16*>(packed_bwd_smem);
  const int k_all = NG * hidden;
  const int ldw = k_all + 8;
  bf16* ring = w_res + (size_t)U * ldw;
  float* part = reinterpret_cast<float*>(ring);
  const int tiles_per_dir = hidden / U;
  const int dir = blockIdx.x >= tiles_per_dir;
  const int u0 = (blockIdx.x - dir * tiles_per_dir) * U;
  const size_t bh = (size_t)batch * hidden;
  const size_t gh = (size_t)k_all;
  const T* xg = dir ? xg_b : xg_f;
  const bf16* hgs = dir ? hgs_b : hgs_f;
  const bf16* ys = dir ? ys_b : ys_f;
  const T* dy = dir ? dy_b : dy_f;
  T* dxg = dir ? dxg_b : dxg_f;
  float* dhg = dir ? dhg_b : dhg_f;
  bf16* xdir = xbuf + (size_t)dir * 2 * batch * gh;
  float* car = dhz + (size_t)dir * bh;
  // the thread's cells of a 16-row pass
  int rows[2], units[2];
  const int n_mine = pass_cells<U>(threadIdx.x, rows, units);

  for (int i = threadIdx.x; i < kPbRingElems; i += kThreads)
    ring[i] = __float2bfloat16(0.0f);
  load_resident(w_res, (dir ? wh_b : wh_f) + (size_t)u0 * gh, gh, U, k_all);

  for (int s = 0; s < n_steps; ++s) {
    // the forward direction walks data T-1..0, the backward one 0..T-1
    const int t = dir ? s : n_steps - 1 - s;
    const int t_cp = dir ? t + 1 : t - 1;  // forward-scan predecessor
    const bool has_cp = t_cp >= 0 && t_cp < n_steps;
    const bf16* a_all = xdir + (size_t)(s & 1) * batch * gh;
    bf16* x_next = xdir + (size_t)((s & 1) ^ 1) * batch * gh;
    for (int r0 = 0; r0 < batch; r0 += kRows) {
      const int nr = min(kRows, batch - r0);
      // the cells' global loads start ahead of the product
      float x[2][NG], hg[2][NG], hp[2], dyv[2], carry[2], mk[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool live = q < n_mine && rows[q] < nr;
        const size_t bu = (size_t)(r0 + rows[q]) * hidden + u0 + units[q];
        const size_t xrow =
            ((size_t)t * batch + r0 + rows[q]) * gh + u0 + units[q];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          x[q][g] = live ? to_f(xg[xrow + (size_t)g * hidden]) : 0.0f;
          hg[q][g] =
              live ? __bfloat162float(hgs[xrow + (size_t)g * hidden]) : 0.0f;
        }
        hp[q] = live && has_cp ? __bfloat162float(ys[(size_t)t_cp * bh + bu])
                               : 0.0f;
        dyv[q] = live ? to_f(dy[(size_t)t * bh + bu]) : 0.0f;
        carry[q] = live ? car[bu] : 0.0f;
        mk[q] = live && mask != nullptr ? mask[bu] : 1.0f;
      }
      if (s > 0)
        packed_bwd_product(a_all + (size_t)r0 * gh, gh, nr, k_all, w_res, ldw,
                           ring, part);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= n_mine || rows[q] >= nr) continue;
        float prod = 0.0f;
        if (s > 0) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            prod += part[((size_t)w * kRows + rows[q]) * kPbCols + units[q]];
        }
        const float dh = dyv[q] + (carry[q] + prod);
        float dx[NG], dhh[NG];
        const float z =
            Cell::backward(x[q], hg[q], hp[q], mk[q], dh, dx, dhh);
        const size_t xrow =
            ((size_t)t * batch + r0 + rows[q]) * gh + u0 + units[q];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          put(dxg + xrow + (size_t)g * hidden, dx[g]);
          if (dhg != nullptr) dhg[xrow + (size_t)g * hidden] = dhh[g];
          x_next[(size_t)(r0 + rows[q]) * gh + (size_t)g * hidden + u0 +
                 units[q]] = __float2bfloat16(dhh[g]);
        }
        car[(size_t)(r0 + rows[q]) * hidden + u0 + units[q]] = dh * z;
      }
      __syncthreads();  // the partials become the ring again
    }
    grid.sync();
  }
}

// Both directions, kPkUnits units a block: 2 * H/20 blocks, every one
// resident; the launch is refused when the card cannot hold them.
template <typename T, typename Cell>
int launch_packed_bwd(const void* xg_f, const void* xg_b, const void* wh_f,
                      const void* wh_b, const void* mask, const void* hgs_f,
                      const void* hgs_b, const void* ys_f, const void* ys_b,
                      const void* dy_f, const void* dy_b, void* dxg_f,
                      void* dxg_b, void* dhg_f, void* dhg_b, void* xbuf,
                      void* dhz, int n_steps, int batch, int hidden,
                      cudaStream_t stream) {
  if (hidden < 80 || hidden % 80 != 0 || n_steps < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&xg_f,  &xg_b,  &wh_f,  &wh_b,  &mask,  &hgs_f,   &hgs_b,
                  &ys_f,  &ys_b,  &dy_f,  &dy_b,  &dxg_f, &dxg_b,   &dhg_f,
                  &dhg_b, &xbuf,  &dhz,   &n_steps, &batch, &hidden};
  return coop_launch((const void*)rec_packed_bwd_kernel<T, Cell>,
                     packed_bwd_smem_bytes(Cell::NG, hidden),
                     2 * (hidden / kPkUnits), true, args, stream);
}

}  // namespace rec
