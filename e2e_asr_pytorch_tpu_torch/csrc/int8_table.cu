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
// decode position each: at the flagship's 16 s bucket the table is
// 16 x 400 x 2560 int8 = 16.4 MB, 4.9 us at the card's 3.35 TB/s. Between
// two positions the decoder reads some 46 MB of its own weights, so the
// table cannot be counted on to stay in the 50 MB L2: the bound is HBM
// bytes. The small operands are kilobytes. What the design is about (the
// readings behind each choice: script/torch_k34_probe.py, PERF.md):
//
//  * No sums across blocks. K3's outputs are columns, K4's are rows: K3
//    cuts D into slices and a block reads all T rows of one slice of one
//    batch row; K4 cuts T into t-ranges and a block reads all of D for one
//    t-range. Every output is then one block's, summed in a fixed order:
//    every launch gives the same bits, with no counters or atomics.
//  * One wave of equal blocks: as many slices or t-ranges as leave every
//    block an SM of its own (a second block on an SM doubles its share);
//    the wrapper's rules give them (ops/kernels/int8_table.py ctx_grid,
//    dattn_grid). At the flagship's shape: 8 a batch row, 128 blocks.
//  * Loads in flight. A block is (lanes, groups) threads: a lane owns a
//    16-column chunk, a group every groups-th row; a thread takes kDepth
//    rows at a time and has the next two such batches' loads in flight
//    while it converts one (and K3's the rows' attention weights with
//    them, so no block barrier comes before the products).
//  * Few instructions a byte. The int8 -> f32 conversion is exact in
//    full-rate instructions (unpack_int8x4): a LOP3 places a byte in the
//    mantissa of 2^23 and one subtraction leaves its value, so a table
//    byte costs a LOP3, an add and an FMA (and a word a shift). An
//    integer-to-float conversion or a byte permute runs at a quarter of
//    that rate.
//  * K3: the groups' partial sums meet in shared memory and each column's
//    are added in group order. K4: a lane holds bf16(dctx[b]) of its chunk
//    in registers for the whole walk; each row's 16-column products go to
//    shared memory, and once a batch of rows is done the block's warps sum
//    each row over its lanes (in lane order, then a shuffle tree). A D
//    wider than the lanes' chunks is walked in passes over column slices,
//    each adding to the rows in order.
//
// A table whose D is not a multiple of 16, or whose base is not 16-byte
// aligned, is read byte by byte through the same loops.
//
// Plain C interface, loaded with ctypes (see ops/kernels/int8_table.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 16;         // int8 values per 16-byte load
constexpr int kThreads = 512;    // lanes x groups, at most
constexpr int kLanesMax = 256;
constexpr int kDepth = 4;        // rows a thread takes at a time

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The 16 table values at p (n_valid of them inside the row; none if
// n_valid <= 0) as four words: one 16-byte load on an aligned table, else
// byte by byte. Missing values read as 0.
template <bool kAligned>
__device__ __forceinline__ int4 load16(const int8_t* p, int n_valid) {
  if (kAligned)
    return n_valid > 0 ? __ldg(reinterpret_cast<const int4*>(p))
                       : make_int4(0, 0, 0, 0);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (i < n_valid)
      w[i / 4] |= (unsigned)(uint8_t)__ldg(p + i) << (8 * (i % 4));
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// The four int8 values of a table word as exact floats, bytes 1 and 3 times
// 256 (their small operand carries the 2^-8 instead, exact for a power of
// two). Each byte, its sign bit flipped (x + 128 in [0, 255]), lands in the
// low mantissa bits of 2^23 by one LOP3, (w & mask) ^ (2^23 | flip), and one
// subtraction leaves x; bytes 2 and 3 are shifted down first.
constexpr float kMagicLo = 8388736.0f;   // 2^23 + 128
constexpr float kMagicHi = 8421376.0f;   // 2^23 + 128 * 256
constexpr float kHiScale = 0.00390625f;  // 2^-8

// (w & mask) ^ bits in one LOP3 (left to itself the compiler makes two)
__device__ __forceinline__ float masked_bits(unsigned w, unsigned mask,
                                             unsigned bits) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(d) : "r"(w), "r"(mask),
      "r"(bits));
  return __uint_as_float(d);
}

__device__ __forceinline__ float4 unpack_int8x4(int word) {
  const unsigned w = (unsigned)word, hi = w >> 16;
  return make_float4(masked_bits(w, 0xFFu, 0x4B000080u) - kMagicLo,
                     masked_bits(w, 0xFF00u, 0x4B008000u) - kMagicHi,
                     masked_bits(hi, 0xFFu, 0x4B000080u) - kMagicLo,
                     masked_bits(hi, 0xFF00u, 0x4B008000u) - kMagicHi);
}

// acc[i] += a * value i of the 16 in v; a_hi = a * 2^-8
__device__ __forceinline__ void ctx_accumulate(float (&acc)[kVec], int4 v,
                                               float a, float a_hi) {
  const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = unpack_int8x4(words[j]);
    acc[4 * j + 0] = fmaf(a, x.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(a_hi, x.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(a, x.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(a_hi, x.w, acc[4 * j + 3]);
  }
}

// sum_i g[i] * value i of the 16 in v (g of bytes 1 and 3 times 2^-8)
__device__ __forceinline__ float dot16(const float (&g)[kVec], int4 v) {
  const int words[4] = {v.x, v.y, v.z, v.w};
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = unpack_int8x4(words[j]);
    s[0] = fmaf(g[4 * j + 0], x.x, s[0]);
    s[1] = fmaf(g[4 * j + 1], x.y, s[1]);
    s[2] = fmaf(g[4 * j + 2], x.z, s[2]);
    s[3] = fmaf(g[4 * j + 3], x.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// The thread's kDepth rows r0 + g + u * groups of the span, its chunk.
template <bool kAligned>
__device__ __forceinline__ void load_rows(int4 (&v)[kDepth], const int8_t* col,
                                          int r0, int g, int groups,
                                          int n_rows, int n_d, int n_valid) {
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int r = r0 + g + u * groups;
    v[u] = load16<kAligned>(col + r * n_d, r < n_rows ? n_valid : 0);
  }
}

// The attention weights of those rows (a group's lanes share a row, so one
// load serves many); they come with the rows and are rounded at use.
__device__ __forceinline__ void load_weights(float (&a)[kDepth],
                                             const float* ab, int r0, int g,
                                             int groups, int n_rows) {
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int r = r0 + g + u * groups;
    a[u] = r < n_rows ? __ldg(ab + r) : 0.0f;
  }
}

// grid (slices, B); block (lanes, groups); dynamic smem
// groups * lanes * (kVec + 1) floats: the groups' partial sums, 16 a thread
// and one of padding (consecutive threads' stores and the sums' reads then
// fall in distinct banks but for one pair).
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
context_int8_kernel(const float* __restrict__ attn2,
                    const int8_t* __restrict__ q, float* __restrict__ out,
                    int n_t, int n_d, int slice) {
  extern __shared__ float part[];
  const int lanes = blockDim.x, groups = blockDim.y;
  const int p = threadIdx.x, g = threadIdx.y;
  const int n_threads = lanes * groups, tid = g * lanes + p;
  const int b = blockIdx.y;
  const int c_lo = blockIdx.x * slice;
  const int c_hi = min(c_lo + slice, (n_d + kVec - 1) / kVec);
  const int batch = kDepth * groups;  // rows the block takes at once
  const float* ab = attn2 + (size_t)b * n_t;
  const int8_t* qb = q + (size_t)b * n_t * n_d;
  float* ob = out + (size_t)b * n_d;

  for (int c0 = c_lo; c0 < c_hi; c0 += lanes) {
    const int c = c0 + p;
    const int n_valid = c < c_hi ? n_d - c * kVec : 0;
    const int8_t* col = qb + c * kVec;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    int4 cur[kDepth], nxt[kDepth];
    float a_cur[kDepth], a_nxt[kDepth];
    load_weights(a_cur, ab, 0, g, groups, n_t);
    load_weights(a_nxt, ab, batch, g, groups, n_t);
    load_rows<kAligned>(cur, col, 0, g, groups, n_t, n_d, n_valid);
    load_rows<kAligned>(nxt, col, batch, g, groups, n_t, n_d, n_valid);
    for (int r0 = 0; r0 < n_t; r0 += batch) {
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (r0 + g + u * groups < n_t) {
          const float a = bf16_round(a_cur[u]);
          ctx_accumulate(acc, cur[u], a, a * kHiScale);
        }
        cur[u] = nxt[u];
        a_cur[u] = a_nxt[u];
      }
      load_weights(a_nxt, ab, r0 + 2 * batch, g, groups, n_t);
      load_rows<kAligned>(nxt, col, r0 + 2 * batch, g, groups, n_t, n_d,
                          n_valid);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) part[tid * (kVec + 1) + i] = acc[i];
    __syncthreads();
    // column d = 16 c + i: the groups' sums in group order (four running
    // sums, then their total), consecutive threads on consecutive columns
    for (int o = tid; o < lanes * kVec; o += n_threads) {
      const int cc = c0 + o / kVec, d = cc * kVec + o % kVec;
      if (cc < c_hi && d < n_d) {
        const float* src = part + (o / kVec) * (kVec + 1) + o % kVec;
        const int stride = lanes * (kVec + 1);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        int gg = 0;
        for (; gg + 4 <= groups; gg += 4) {
          s0 += src[gg * stride];
          s1 += src[(gg + 1) * stride];
          s2 += src[(gg + 2) * stride];
          s3 += src[(gg + 3) * stride];
        }
        for (; gg < groups; ++gg) s0 += src[gg * stride];
        ob[d] = (s0 + s1) + (s2 + s3);
      }
    }
    __syncthreads();
  }
}

// grid (splits, B); block (lanes, groups); dynamic smem
// 2 * kDepth * groups * lanes floats: two batches of rows' products, one
// filled while the other is summed.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
dattn_int8_kernel(const float* __restrict__ dctx,
                  const int8_t* __restrict__ q, float* __restrict__ out,
                  int n_t, int n_d, int rows) {
  extern __shared__ float prod[];
  const int lanes = blockDim.x, groups = blockDim.y;
  const int p = threadIdx.x, g = threadIdx.y;
  const int tid = g * lanes + p, lane = tid & 31, warp = tid >> 5;
  const int n_warps = lanes * groups / 32;
  const int split = blockIdx.x, b = blockIdx.y;
  const int t0 = split * rows;
  const int n_rows = min(rows, n_t - t0);
  const int chunks = (n_d + kVec - 1) / kVec;
  const int batch = kDepth * groups;  // rows the block takes at once
  const int8_t* span = q + ((size_t)b * n_t + t0) * n_d;
  float* ob = out + (size_t)b * n_t + t0;

  for (int c0 = 0; c0 < chunks; c0 += lanes) {
    const int c = c0 + p;
    const int n_valid = c < chunks ? n_d - c * kVec : 0;
    const int8_t* col = span + c * kVec;
    // the lane's bf16(dctx), bytes 1 and 3 of a word times 2^-8 (see
    // unpack_int8x4); its loads go first: behind the table's they would
    // arrive last
    float gv[kVec];
    const float* src = dctx + (size_t)b * n_d + c * kVec;
    if (kAligned && n_valid > 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src) + j);
        gv[4 * j + 0] = bf16_round(f.x);
        gv[4 * j + 1] = bf16_round(f.y) * kHiScale;
        gv[4 * j + 2] = bf16_round(f.z);
        gv[4 * j + 3] = bf16_round(f.w) * kHiScale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        gv[i] = i < n_valid ? bf16_round(__ldg(src + i)) *
                                  (i % 2 ? kHiScale : 1.0f)
                            : 0.0f;
    }
    int4 cur[kDepth], nxt[kDepth];
    load_rows<kAligned>(cur, col, 0, g, groups, n_rows, n_d, n_valid);
    load_rows<kAligned>(nxt, col, batch, g, groups, n_rows, n_d, n_valid);
    for (int r0 = 0, buf = 0; r0 < n_rows; r0 += batch, buf ^= 1) {
      float* pb = prod + buf * batch * lanes;
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (r0 + g + u * groups < n_rows)  // the same in a warp
          pb[(u * groups + g) * lanes + p] = dot16(gv, cur[u]);
        cur[u] = nxt[u];
      }
      load_rows<kAligned>(nxt, col, r0 + 2 * batch, g, groups, n_rows, n_d,
                          n_valid);
      __syncthreads();
      // row r0 + i of the batch: its lanes' products in lane order, then a
      // shuffle tree; the other buffer takes the next batch meanwhile
      for (int i = warp; i < batch && r0 + i < n_rows; i += n_warps) {
        float s = 0.0f;
        for (int k = lane; k < lanes; k += 32) s += pb[i * lanes + k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) ob[r0 + i] = c0 == 0 ? s : ob[r0 + i] + s;
      }
    }
    __syncthreads();
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool valid_block(int lanes, int groups) {
  return lanes >= 1 && lanes <= kLanesMax && groups >= 1 &&
         lanes * groups <= kThreads;
}

}  // namespace

// Both return a cudaError_t code (0 on success). All pointers come from
// contiguous PyTorch tensors: q (B, T, D) int8, attn2 (B, T), dctx (B, D)
// and the outputs f32. The grids and blocks are the wrapper's rules
// (ops/kernels/int8_table.py ctx_grid, dattn_grid): K3's `slices` D-slices
// of `slice` 16-column chunks, K4's `splits` t-ranges of `rows` rows, each
// a block of (lanes, groups) threads.
extern "C" int context_int8(const void* attn2, const void* q, void* out,
                            int batch, int n_t, int n_d, int slices,
                            int slice, int lanes, int groups, void* stream) {
  if (slices < 1 || slice < 1 || !valid_block(lanes, groups))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * groups * lanes * (kVec + 1);
  const bool aligned = n_d % kVec == 0 && aligned16(q);
  const dim3 grid(slices, batch), block(lanes, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(attn2);
  const int8_t* t = static_cast<const int8_t*>(q);
  float* o = static_cast<float*>(out);
  if (aligned)
    context_int8_kernel<true><<<grid, block, smem, s>>>(a, t, o, n_t, n_d,
                                                        slice);
  else
    context_int8_kernel<false><<<grid, block, smem, s>>>(a, t, o, n_t, n_d,
                                                         slice);
  return (int)cudaGetLastError();
}

extern "C" int dattn_int8(const void* dctx, const void* q, void* out,
                          int batch, int n_t, int n_d, int splits, int rows,
                          int lanes, int groups, void* stream) {
  if (splits < 1 || lanes % 32 != 0 || !valid_block(lanes, groups))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * kDepth * groups * lanes;
  const bool aligned = n_d % kVec == 0 && aligned16(q) && aligned16(dctx);
  const dim3 grid(splits, batch), block(lanes, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dctx);
  const int8_t* t = static_cast<const int8_t*>(q);
  float* o = static_cast<float*>(out);
  if (aligned)
    dattn_int8_kernel<true><<<grid, block, smem, s>>>(g, t, o, n_t, n_d, rows);
  else
    dattn_int8_kernel<false><<<grid, block, smem, s>>>(g, t, o, n_t, n_d,
                                                       rows);
  return (int)cudaGetLastError();
}
