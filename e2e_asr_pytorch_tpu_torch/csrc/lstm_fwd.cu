// Single-direction LSTM forward recurrence for Hopper (sm_90a):
// lstm_fwd_chunked_kernel, in two tile widths, serves two TPU kernels of
// e2e_asr_pytorch_tpu/ops/pallas/lstm.py.
//
//   K6f  `_fwd_kernel_chunked` / `_lstm_fwd_pallas_chunked`: a w_h too large
//        to hold, the part that does not fit streamed every step, forward
//        order only; tiles of 16 units (the 4x LSTM-2048 LM).
//   K5f  `_fwd_kernel` / `_lstm_fwd_pallas`, its wide form (a batch above one
//        m16 tile of rows: the 4x LSTM-1024 LM's 128): the same kernel with
//        `reverse` as a time index map (t = T-1-s, no flips) and tiles of 8
//        units, which at H=1024 keep the whole slab resident. K5f's narrow
//        form (B <= 16) is K1's resident kernel over one direction
//        (bilstm_fwd.cu); ops/kernels/lstm.py `form_for` picks.
//
// It computes, from a zero state, per step
//
//     gates = xg[t] + bf16(h_prev) @ bf16(w_h)      (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid  (gate order i,f,g,o)
//     c = f * c_prev + i * g ;  h = o * tanh(c)     (c and h carried in f32)
//
// and writes ys in xg's dtype (f32 or bf16) and, when their pointers are
// non-null, the bf16 stashes of c and of the f32 gate pre-activations.
//
// Design. One persistent cooperative launch per layer. A block owns tiles
// of U hidden units (their 4U gate columns, for all B rows) so a unit's cell
// state is touched by its owner only; bf16(h) is exchanged through a
// double-buffered global buffer. The tile's gate columns are ordered
// gate-major, so a thread's accumulators hold all four gates of its (row,
// unit) cells and the cell update needs no exchange. What bounds a step on
// the H100 is not the operations but the chain of T dependent steps, each:
// grid barrier -> first tile of the new h -> product -> cell update. The
// mma.sync kernels this one replaced (fed by a cp.async ring) waited at a
// block-wide barrier per 64 k values and re-read every B fragment once per
// warp. What this kernel does about it:
//   - The product is wgmma m64n(4U)k16: two consumer warpgroups, one per 64
//     rows of the 128-row pass, A (h) and B (w) both from shared memory in
//     the 128-byte swizzle, sums in registers (two chains a warpgroup). A
//     warpgroup whose rows lie beyond the batch issues nothing; the exchange
//     buffer holds 128 rows per pass whatever the batch, its unused rows
//     zero and never written.
//   - A producer warp issues bulk copies (the TMA unit without a tensor map)
//     into rings guarded by full / empty mbarriers; no block-wide barrier in
//     the k loop. The tiles' images in global memory are already swizzled:
//     a small kernel packs w_h so, and the cell update writes bf16(h) so
//     (hopper_async.cuh), so a k-tile is one contiguous copy.
//   - A k-tile is 128 k values: every hand-over of a tile costs the tensor
//     cores ~0.2 us whatever is in flight, so 16 of them a step beat 32.
//   - As many k-tiles of the slab as fit beside the rings stay in shared
//     memory for the whole sequence (K6f at H=2048: 6 of 16; K5f at H=1024:
//     all 8; computed by the wrapper from the card's opt-in shared memory);
//     only the others are streamed, spread evenly over the k loop.
//   - The grid barrier is split: a block arrives once its cells are stored,
//     and only its producer warp waits, before it fetches the new h.
// Every block reads all of h from L2 every step. Thread block clusters with
// each tile of h multicast would divide those reads; tried on this card, they
// combine with the cooperative launch in clusters of 2 and make the step no
// shorter (a block's own intake, not L2, bounds the copies), so the kernel is
// launched without them.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, bf16 with stashes: K6f at
// T=160 B=128 H=2048 3.47 ms (21.7 us a step) against 5.15 ms for cuDNN's
// LSTM with its input projection; K5f's wide form at T=160 B=128 H=1024 1.82
// ms (11.4 us a step) against 3.12-3.31 ms for the mma.sync kernel it
// replaced and 2.4-2.9 ms for cuDNN (chip_smoke.py, script/torch_k5_time.py);
// K6f's 16-unit tiles measured slower there (script/torch_k5_forms.py;
// PERF.md has the tables).
// Later work: the product runs the tensor cores at half their rate (a
// wgmma of n <= 64 from shared memory is bound by operand reads).
//
// Plain C interface, loaded with ctypes (see ops/kernels/lstm.py).

#include "hopper_async.cuh"
#include "lstm_common.cuh"

namespace {

using namespace lstm;

using namespace hopper;

// Geometry (ops/kernels/lstm.py mirrors the sizes). A tile is U hidden units
// (their 4U gate columns: wgmma's n) for every batch row.
constexpr int kPassRows = 128;      // batch rows per pass: two m64 tiles
constexpr int kConsumerWarps = 8;   // two warpgroups
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kChunkedThreads = kConsumerThreads + 32;  // + the producer warp
// A k-tile, the unit of the rings, of their barriers and of residency, is
// kGroup swizzle atoms of 64 k values, adjacent in the packed w_h and in the
// exchange buffer, so one bulk copy brings it. Every hand-over of a tile
// between producer and consumers costs the tensor cores a pause (measured:
// ~0.2 us), so a tile of two atoms beats one although fewer tiles then fit
// as residents.
constexpr int kGroup = 2;
constexpr int kKTile = kGroup * kTileK;     // k values per k-tile
constexpr int kHAtom = kPassRows * kTileK;  // bf16 values of one atom of h
constexpr int kHTile = kGroup * kHAtom;
constexpr uint32_t kHTileBytes = kHTile * sizeof(bf16);  // 32 KB
constexpr int kHStages = 3;  // ring of h k-tiles
constexpr int kWStages = 2;  // ring of streamed w k-tiles
static_assert(kHStages >= 3, "a tile in use, one behind it, one in flight");
constexpr int kMaxKTiles = 128;  // two mask words (ResidentSet)
// Two accumulator chains per warpgroup, the k16 steps of a tile going round
// them and the chains summed at the end: a little faster than one chain of
// dependent accumulations (measured), and four spill.
constexpr int kChains = 2;

template <int U>
struct Tile {
  static constexpr int kCols = 4 * U;           // gate columns: wgmma's n
  static constexpr int kOct = U / 8;            // n8 tiles of one gate
  static constexpr int kAcc = kCols / 2;        // accumulator floats a thread
  static constexpr int kWAtom = kCols * kTileK;  // bf16 of an atom of a slab
  static constexpr int kWTile = kGroup * kWAtom;
  static constexpr uint32_t kWTileBytes = kWTile * sizeof(bf16);
  // alignment slack + the two rings + 1 KB for the barriers; the resident
  // k-tiles lie between the rings and the barriers
  static constexpr size_t kFixedBytes =
      1024 + kHStages * kHTileBytes + kWStages * kWTileBytes + 1024;
};

// k-tile kt of a slab is resident when the running share of resident tiles
// steps there, which spreads the streamed ones evenly over the k loop. Every
// thread keeps the set as a bit mask in two registers.
struct ResidentSet {
  uint64_t lo, hi;
  __device__ __forceinline__ ResidentSet(int n_res, int n_kt) : lo(0), hi(0) {
    for (int kt = 0; kt < n_kt; ++kt) {
      if ((kt + 1) * n_res / n_kt > kt * n_res / n_kt) {
        if (kt < 64)
          lo |= 1ull << kt;
        else
          hi |= 1ull << (kt - 64);
      }
    }
  }
  __device__ __forceinline__ bool has(int kt) const {
    return ((kt < 64 ? lo >> kt : hi >> (kt - 64)) & 1) != 0;
  }
  // index of resident k-tile kt among the resident ones
  __device__ __forceinline__ int index(int kt) const {
    if (kt < 64) return __popcll(lo & ((1ull << kt) - 1));
    return __popcll(lo) + __popcll(hi & ((1ull << (kt - 64)) - 1));
  }
};

// wp:   packed w_h, (H/U, H/64, 4U, 64) bf16: tile, atom, gate column
//       g*U + j (column g*H + U*tile + j of w_h), 64 k values with their
//       16-byte chunks in the 128-byte swizzle of the column's row
//       (lstm_pack_chunked_kernel below writes it).
// hbuf: (2 buffers, ceil(B/128), H/64, 128, 64) bf16, swizzled the same way
//       by row; zeroed by the caller (buffer 0 is the initial state, and rows
//       beyond the batch are read but never written).
// cbuf: (B, H) f32, zeroed by the caller.
// step_counter: one u32, zeroed by the caller: the grid barrier.
// A block owns tiles blockIdx.x + i * gridDim.x, i < tiles_per_block, and
// keeps resident_ktiles k-tiles of each in shared memory. `hidden` is a
// multiple of kKTile. Step s handles data index t = s, or T-1-s with
// `reverse`.
//
// The grid barrier is split. A block arrives (one atomic add) when its
// consumers have stored their cells; only the producer warp waits for all
// arrivals, before it fetches the new h: the consumers go straight on to
// their next loads and meet the new h at the ring's barriers. A block can
// run at most one step ahead of the slowest, which is what the two exchange
// buffers allow: its writes of step s+1 follow its reads of all blocks'
// writes of step s, which follow those blocks' reads of step s.
template <typename T, int U>
__global__ void __launch_bounds__(kChunkedThreads, 1)
lstm_fwd_chunked_kernel(const T* __restrict__ xg, const bf16* __restrict__ wp,
                        T* ys, bf16* cs, bf16* gs, bf16* hbuf, float* cbuf,
                        uint32_t* step_counter, int n_steps, int batch,
                        int hidden, int tiles_per_block, int resident_ktiles,
                        int reverse) {
  using G = Tile<U>;
  extern __shared__ unsigned char chunked_smem[];
  unsigned char* base =
      chunked_smem + ((1024 - (shared_addr(chunked_smem) & 1023)) & 1023);
  bf16* h_ring = reinterpret_cast<bf16*>(base);
  bf16* w_ring = h_ring + kHStages * kHTile;
  bf16* w_res = w_ring + kWStages * G::kWTile;
  uint64_t* full_h = reinterpret_cast<uint64_t*>(
      w_res + (size_t)tiles_per_block * resident_ktiles * G::kWTile);
  uint64_t* empty_h = full_h + kHStages;
  uint64_t* full_w = empty_h + kHStages;
  uint64_t* empty_w = full_w + kWStages;
  uint64_t* res_bar = empty_w + kWStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_kt = hidden / kKTile;
  const int n_atoms = hidden / kTileK;
  const int n_tiles = hidden / U;
  const int n_rb = (batch + kPassRows - 1) / kPassRows;
  const size_t buf_elems = (size_t)n_rb * n_kt * kHTile;
  const ResidentSet resident(resident_ktiles, n_kt);

  if (tid == 0) {
    for (int i = 0; i < kHStages; ++i) {
      mbar_init(full_h + i, 1);
      mbar_init(empty_h + i, kConsumerWarps);
    }
    for (int i = 0; i < kWStages; ++i) {
      mbar_init(full_w + i, 1);
      mbar_init(empty_w + i, kConsumerWarps);
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
        for (int kt = 0; kt < n_kt; ++kt) {
          if (resident.has(kt))
            bulk_load(w_res + ((size_t)local * resident_ktiles +
                               resident.index(kt)) * G::kWTile,
                      wp + ((size_t)tile * n_kt + kt) * G::kWTile,
                      G::kWTileBytes, res_bar);
        }
      }
    }
    uint32_t it_h = 0, it_w = 0;
    for (int s = 0; s < n_steps; ++s) {
      const bf16* h_prev = hbuf + (size_t)(s & 1) * buf_elems;
      // every block has stored its h of step s - 1 ...
      const uint32_t arrivals = (uint32_t)s * gridDim.x;
      while (load_acquire(step_counter) < arrivals) {
      }
      // ... with plain stores, which the bulk copies must see
      fence_proxy_async();
      for (int local = 0; local < tiles_per_block; ++local) {
        const int tile = min((int)(blockIdx.x + local * gridDim.x),
                             n_tiles - 1);
        for (int rb = 0; rb < n_rb; ++rb) {
          for (int kt = 0; kt < n_kt; ++kt) {
            const int sh = it_h % kHStages;
            mbar_wait(empty_h + sh, ((it_h / kHStages) & 1) ^ 1);
            ++it_h;
            if (lane == 0) {
              mbar_arrive_expect_tx(full_h + sh, kHTileBytes);
              bulk_load(h_ring + sh * kHTile,
                        h_prev + ((size_t)rb * n_kt + kt) * kHTile,
                        kHTileBytes, full_h + sh);
            }
            if (!resident.has(kt)) {
              const int sw = it_w % kWStages;
              mbar_wait(empty_w + sw, ((it_w / kWStages) & 1) ^ 1);
              ++it_w;
              if (lane == 0) {
                mbar_arrive_expect_tx(full_w + sw, G::kWTileBytes);
                bulk_load(w_ring + sw * G::kWTile,
                          wp + ((size_t)tile * n_kt + kt) * G::kWTile,
                          G::kWTileBytes, full_w + sw);
              }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 ----------
    const int wg = warp >> 2;
    const int row_in_wg = (warp & 3) * 16 + (lane >> 2);
    const int col2 = 2 * (lane & 3);  // the thread's unit pair in an octet
    const size_t h4 = (size_t)4 * hidden;
    // a warp hands k-tile j of the pass that began at ring positions
    // (h0, w0) back to the producer
    auto hand_back = [&](uint32_t h0, uint32_t& rel_w, int j) {
      const bool streamed = !resident.has(j);
      const int sw = rel_w % kWStages;
      if (streamed) ++rel_w;
      if (lane != 0) return;
      mbar_arrive(empty_h + (h0 + j) % kHStages);
      if (streamed) mbar_arrive(empty_w + sw);
    };
    if (resident_ktiles > 0) mbar_wait(res_bar, 0);
    uint32_t it_h = 0, it_w = 0;
    for (int s = 0; s < n_steps; ++s) {
      const int t = reverse ? n_steps - 1 - s : s;
      bf16* h_next = hbuf + (size_t)((s & 1) ^ 1) * buf_elems;
      for (int local = 0; local < tiles_per_block; ++local) {
        const int tile_raw = blockIdx.x + local * gridDim.x;
        const bool valid = tile_raw < n_tiles;
        const int u0 = min(tile_raw, n_tiles - 1) * U;
        for (int rb = 0; rb < n_rb; ++rb) {
          const int r0 = rb * kPassRows;
          const int nr = min(kPassRows, batch - r0);
          const bool active = wg * 64 < nr;  // uniform over the warpgroup
          // The thread's cells: rows rl[hh], unit pairs u0 + 8 jj + col2 +
          // {0,1}. Their global loads (xg from HBM, c) start ahead of the
          // product.
          int rl[2];
          bool ok[2];
          typename Pair<T>::type pre[2][G::kOct][4];
          float2 c_prev[2][G::kOct];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            rl[hh] = wg * 64 + row_in_wg + 8 * hh;
            ok[hh] = valid && rl[hh] < nr;
            const size_t xrow = ((size_t)t * batch + r0 + rl[hh]) * h4;
            const size_t crow = (size_t)(r0 + rl[hh]) * hidden;
#pragma unroll
            for (int jj = 0; jj < G::kOct; ++jj) {
              const int u = u0 + 8 * jj + col2;
#pragma unroll
              for (int g = 0; g < 4; ++g)
                if (ok[hh])
                  pre[hh][jj][g] = load2(xg + xrow + (size_t)g * hidden + u);
              if (ok[hh]) c_prev[hh][jj] = load2(cbuf + crow + u);
            }
          }

          float acc[kChains][G::kAcc];
#pragma unroll
          for (int c = 0; c < kChains; ++c)
#pragma unroll
            for (int i = 0; i < G::kAcc; ++i) acc[c][i] = 0.0f;
          // k-tile j of this pass sits in h stage (h0 + j) % kHStages; the
          // streamed ones take the w stages in order
          const uint32_t h0 = it_h;
          uint32_t rel_w = it_w;
          for (int kt = 0; kt < n_kt; ++kt) {
            const int sh = it_h % kHStages;
            mbar_wait(full_h + sh, (it_h / kHStages) & 1);
            ++it_h;
            const bf16* w_tile;
            if (resident.has(kt)) {
              w_tile = w_res + ((size_t)local * resident_ktiles +
                                resident.index(kt)) * G::kWTile;
            } else {
              const int sw = it_w % kWStages;
              mbar_wait(full_w + sw, (it_w / kWStages) & 1);
              ++it_w;
              w_tile = w_ring + sw * G::kWTile;
            }
            if (active) {
              wgmma_fence();
#pragma unroll
              for (int sub = 0; sub < kGroup; ++sub) {
                const uint64_t da = swizzled_desc(
                    h_ring + sh * kHTile + sub * kHAtom + wg * 64 * kTileK);
                const uint64_t db = swizzled_desc(w_tile + sub * G::kWAtom);
#pragma unroll
                for (int kk = 0; kk < kTileK / 16; ++kk)
                  wgmma_k16(acc[kk % kChains], da + 2 * kk, db + 2 * kk);
              }
              wgmma_commit();
            }
            if (kt > 0) {  // the tile before this one has been read
              if (active) wgmma_wait<1>();
              hand_back(h0, rel_w, kt - 1);
            }
          }
          if (active) wgmma_wait<0>();
          hand_back(h0, rel_w, n_kt - 1);
#pragma unroll
          for (int c = 0; c < kChains; ++c) fence_acc(acc[c]);
#pragma unroll
          for (int c = 1; c < kChains; ++c)
#pragma unroll
            for (int i = 0; i < G::kAcc; ++i) acc[0][i] += acc[c][i];

          // cell update: n-tile g kOct + jj of the accumulator is gate g of
          // the tile's units 8 jj .. 8 jj + 7
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (!ok[hh]) continue;
            const size_t xrow = ((size_t)t * batch + r0 + rl[hh]) * h4;
            const size_t crow = (size_t)(r0 + rl[hh]) * hidden;
#pragma unroll
            for (int jj = 0; jj < G::kOct; ++jj) {
              const int u = u0 + 8 * jj + col2;
              float gate[4][2], c_new[2], h_new[2];
              const float c_old[2] = {c_prev[hh][jj].x, c_prev[hh][jj].y};
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                const float2 x = widen(pre[hh][jj][g]);
                const int n = (g * G::kOct + jj) * 4 + 2 * hh;
                gate[g][0] = x.x + acc[0][n];
                gate[g][1] = x.y + acc[0][n + 1];
              }
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float ig = sigmoid_f(gate[0][e]);
                const float fg = sigmoid_f(gate[1][e]);
                const float gg = tanhf(gate[2][e]);
                const float og = sigmoid_f(gate[3][e]);
                c_new[e] = fg * c_old[e] + ig * gg;
                h_new[e] = og * tanhf(c_new[e]);
              }
              store2(cbuf + crow + u, c_new[0], c_new[1]);
              // bf16(h) into the next step's A tiles, swizzled by row
              const int chunk = (u % kTileK) / 8;
              store2(h_next +
                         (((size_t)rb * n_atoms + u / kTileK) * kPassRows +
                          rl[hh]) * kTileK +
                         swizzled_chunk(rl[hh], chunk) * 8 + (u % 8),
                     h_new[0], h_new[1]);
              const size_t o = ((size_t)t * batch + r0 + rl[hh]) * hidden + u;
              store2(ys + o, h_new[0], h_new[1]);
              if (cs != nullptr) store2(cs + o, c_new[0], c_new[1]);
              if (gs != nullptr) {
#pragma unroll
                for (int g = 0; g < 4; ++g)
                  store2(gs + xrow + (size_t)g * hidden + u, gate[g][0],
                         gate[g][1]);
              }
            }
          }
        }
      }
      // arrive at the grid barrier: the block's plain stores of h, made
      // visible to the other blocks' bulk copies, then one count
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
// padded H (`hp`) for tiles of U units: one block per (tile, atom)
// transposes a 64 k x 4U column piece through shared memory, rounds it to
// bf16 and writes each column's 64 k values with the 16-byte chunks
// swizzled. Units and k at and beyond `hidden` are zero.
template <typename W, int U>
__global__ void __launch_bounds__(256)
lstm_pack_chunked_kernel(const W* __restrict__ w_h, bf16* __restrict__ wp,
                         int hidden, int hp) {
  using G = Tile<U>;
  __shared__ float piece[kTileK][G::kCols + 1];
  const int n_atoms = hp / kTileK;
  const int tile = blockIdx.x / n_atoms;
  const int atom = blockIdx.x % n_atoms;
  for (int i = threadIdx.x; i < kTileK * G::kCols; i += 256) {
    const int k = i / G::kCols, n = i % G::kCols;
    const int row = atom * kTileK + k;
    const int unit = tile * U + n % U;
    float v = 0.0f;
    if (row < hidden && unit < hidden)
      v = to_f(w_h[(size_t)row * 4 * hidden + (size_t)(n / U) * hidden +
                   unit]);
    piece[k][n] = v;
  }
  __syncthreads();
  bf16* out = wp + (size_t)blockIdx.x * G::kWAtom;
  for (int i = threadIdx.x; i < G::kCols * 8; i += 256) {
    const int n = i / 8, chunk = i % 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __float2bfloat16(piece[chunk * 8 + e][n]);
    *reinterpret_cast<uint4*>(out + n * kTileK +
                              swizzled_chunk(n, chunk) * 8) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// One cooperative launch of the chunked kernel: every block must be
// co-resident, since the kernel's own grid barrier spins. Refused
// (cudaErrorCooperativeLaunchTooLarge) when the card cannot hold them all.
template <typename T, int U>
int launch_chunked(const void* xg, const void* wp, void* ys, void* cs,
                   void* gs, void* hbuf, void* cbuf, void* step_counter,
                   int n_steps, int batch, int hidden, int tiles_per_block,
                   int resident_ktiles, int reverse, cudaStream_t stream) {
  using G = Tile<U>;
  const void* kernel = (const void*)lstm_fwd_chunked_kernel<T, U>;
  const int n_tiles = hidden / U;
  const int grid = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const size_t smem =
      G::kFixedBytes +
      (size_t)tiles_per_block * resident_ktiles * G::kWTileBytes;
  void* args[] = {&xg,      &wp,    &ys,     &cs,
                  &gs,      &hbuf,  &cbuf,   &step_counter,
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

template <int U>
int launch_chunked_units(const void* xg, const void* wp, void* ys, void* cs,
                         void* gs, void* hbuf, void* cbuf, void* step_counter,
                         int n_steps, int batch, int hidden,
                         int tiles_per_block, int resident_ktiles,
                         int reverse, int xg_bf16, cudaStream_t stream) {
  if (xg_bf16)
    return launch_chunked<bf16, U>(xg, wp, ys, cs, gs, hbuf, cbuf,
                                   step_counter, n_steps, batch, hidden,
                                   tiles_per_block, resident_ktiles, reverse,
                                   stream);
  return launch_chunked<float, U>(xg, wp, ys, cs, gs, hbuf, cbuf,
                                  step_counter, n_steps, batch, hidden,
                                  tiles_per_block, resident_ktiles, reverse,
                                  stream);
}

template <int U>
int launch_pack(const void* w_h, void* wp, int hidden, int hp, int w_bf16,
                cudaStream_t stream) {
  const int grid = (hp / U) * (hp / kTileK);
  if (w_bf16)
    lstm_pack_chunked_kernel<bf16, U><<<grid, 256, 0, stream>>>(
        static_cast<const bf16*>(w_h), static_cast<bf16*>(wp), hidden, hp);
  else
    lstm_pack_chunked_kernel<float, U><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(w_h), static_cast<bf16*>(wp), hidden, hp);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return a cudaError_t code (0 on success). All pointers come from fresh
// PyTorch allocations (256-byte aligned). `units` is the tile's hidden units,
// 16 or 8.
//
// lstm_fwd_chunked: xg_bf16 selects the dtype of xg and ys (1: bf16, 0: f32);
// null cs/gs pointers skip the stash stores. `hidden` a multiple of 128 (the
// wrapper pads) and at most 128 k-tiles wide; wp, hbuf, cbuf and
// step_counter as at lstm_fwd_chunked_kernel; tiles_per_block *
// resident_ktiles k-tiles of 8 * units KB must fit the block's shared
// memory beside Tile<units>::kFixedBytes. A grid the card cannot hold
// co-resident is refused.
extern "C" int lstm_fwd_chunked(const void* xg, const void* wp, void* ys,
                                void* cs, void* gs, void* hbuf, void* cbuf,
                                void* step_counter, int n_steps, int batch,
                                int hidden, int tiles_per_block,
                                int resident_ktiles, int reverse, int units,
                                int xg_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden < kKTile || hidden % kKTile != 0 ||
      hidden / kKTile > kMaxKTiles || n_steps < 1 || batch < 1 ||
      tiles_per_block < 1 || resident_ktiles < 0 ||
      resident_ktiles > hidden / kKTile)
    return (int)cudaErrorInvalidValue;
  if (units == 16)
    return launch_chunked_units<16>(xg, wp, ys, cs, gs, hbuf, cbuf,
                                    step_counter, n_steps, batch, hidden,
                                    tiles_per_block, resident_ktiles, reverse,
                                    xg_bf16, st);
  if (units == 8)
    return launch_chunked_units<8>(xg, wp, ys, cs, gs, hbuf, cbuf,
                                   step_counter, n_steps, batch, hidden,
                                   tiles_per_block, resident_ktiles, reverse,
                                   xg_bf16, st);
  return (int)cudaErrorInvalidValue;
}

// lstm_pack_chunked: w_h (hidden, 4*hidden), f32 (w_bf16 = 0) or bf16 -> wp
// (hp/units, hp/64, 4*units, 64) bf16, hp >= hidden a multiple of 64.
extern "C" int lstm_pack_chunked(const void* w_h, void* wp, int hidden, int hp,
                                 int units, int w_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden < 1 || hp < hidden || hp % kTileK != 0)
    return (int)cudaErrorInvalidValue;
  if (units == 16) return launch_pack<16>(w_h, wp, hidden, hp, w_bf16, st);
  if (units == 8) return launch_pack<8>(w_h, wp, hidden, hp, w_bf16, st);
  return (int)cudaErrorInvalidValue;
}
