#!/usr/bin/env python3
"""The readings behind the design of K3 and K4 (csrc/int8_table.cu), on the
card.

    python3 script/torch_k34_probe.py [--variants NAME,...]

Builds patched copies of csrc/int8_table.cu, each a design the kernels
were chosen over, into probes/k34/ (a directory git ignores; the
production source is not touched), prints what ptxas says of each kernel
(registers, spills), holds each copy against the plain versions and times
K3 and K4 at B=16 T=400 D=2560 with a warm and a cold L2 (chip_smoke.py's
``_time_ms`` / ``_cold_ms``), the copy as built first. The variants:

  i2f, prmt  the int8 -> f32 conversion by the integer-to-float instruction
             (a shift pair and I2F a byte), or by a byte permute into the
             mantissa of 2^23 and a subtraction, in place of the LOP3
  depth2, depth8
             batches of 2 or 8 rows a thread, not 4 (two batches' loads in
             flight: 4 or 16 a thread, not 8)
  parts9, parts16
             9 or 16 D-slices (K3) and t-ranges (K4) a batch row, 144 or 256
             blocks at B=16 (a second block on some SMs), not the rules' 8
  k3_t_ranges
             K3 over t-ranges of all of D (as K4 is cut), each block's
             partial row summed by the last block of its batch row to
             arrive at a counter (one release/acquire atomic a block), in
             t-range order: the cut before the D-slices
  k3_t_ranges_cluster
             the same, the partial rows summed through a thread-block
             cluster along t instead (each block a slice of D over its
             cluster's shared rows, in rank order; 8 t-ranges, the portable
             cluster limit)
  k3_t_ranges_bulk_ring
             the same with a counter, the rows delivered by bulk copies
             (one thread, `groups` rows a copy) into an 8-slot mbarrier ring
             instead of the threads' own 16-byte loads
  k4_warp_rows
             K4 as a warp a row: each lane holds bf16(dctx) of up to 5
             chunks in registers, the next row's loads in flight, a
             shuffle sum a row, 6 warps a block
  empty, no_loads, loads_only
             where the time goes, wrong by construction (only the times are
             read): both kernels returning at once (the launch alone); no
             table loads (the values made from the address); the loads
             without the conversion and products (one xor a load)
  stamps     the copy as built with time stamps: thread 0 of each block
             reads the global timer and the SM's clock at the ends of the
             phases (entry, first batch, main loop (K3), end), once with a
             warm L2 and once with a cold one; printed as each phase's
             median and largest end over the blocks, from the first entry

Then the static SASS opcode counts of every kernel of the copy as built and
of the i2f and prmt copies (cuobjdump -sass), and the wrapper's host time a
call split into its parts. With ``--same-sass DIR`` it only compiles the
package's other sources here and in DIR (say an unpacked parent commit) and
says whether their instructions are the same.
"""

import argparse
import collections
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "e2e_asr_pytorch_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "probes", "k34")
SHAPE = (16, 400, 2560)

_UNPACK = """  const unsigned w = (unsigned)word, hi = w >> 16;
  return make_float4(masked_bits(w, 0xFFu, 0x4B000080u) - kMagicLo,
                     masked_bits(w, 0xFF00u, 0x4B008000u) - kMagicHi,
                     masked_bits(hi, 0xFFu, 0x4B000080u) - kMagicLo,
                     masked_bits(hi, 0xFF00u, 0x4B008000u) - kMagicHi);"""
_CTX_FMA = """    acc[4 * j + 0] = fmaf(a, x.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(a_hi, x.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(a, x.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(a_hi, x.w, acc[4 * j + 3]);"""
_DOT_FMA = """    s[0] = fmaf(g[4 * j + 0], x.x, s[0]);
    s[1] = fmaf(g[4 * j + 1], x.y, s[1]);
    s[2] = fmaf(g[4 * j + 2], x.z, s[2]);
    s[3] = fmaf(g[4 * j + 3], x.w, s[3]);"""
# a patch is (old, new): old a text to replace, or a (start, end) pair of
# markers around a region replaced whole, the end marker kept (None: to
# the end of the file)
_K4 = ("// grid (splits, B); block (lanes, groups); dynamic smem\n// 2 * kDepth",
       "bool aligned16(const void* p) {")
_CTX_ENTRY = ("extern \"C\" int context_int8(", "extern \"C\" int dattn_int8(")
_DATTN_ENTRY = ("extern \"C\" int dattn_int8(", None)

# K3 over t-ranges of all of D, the partial rows summed across blocks by the
# last block of a batch row to arrive at a counter (the design before the
# D-slices); its scratch lives in the copy, for the probe's shape
K3_T_RANGES_KERNEL = """constexpr int kSumGroup = 8;  // partial rows the last block loads at once

// The arrival of a block at its batch row's counter: an atomic add with
// release and acquire semantics at the device's scope, after a block
// barrier, so that every partial row the block wrote is seen by the last
// block (and the last block sees all of them); returns the count before.
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// grid (splits, B); block (lanes, groups); dynamic smem
// groups * kVec * (lanes + 2) floats: the groups' partial sums.
// partial (B, splits, D) and arrived (B,) are the wrapper's scratch, arrived
// zero at launch (and left zero); with one split the block writes out
// itself.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
context_rows_kernel(const float* __restrict__ attn2,
                    const int8_t* __restrict__ q, float* __restrict__ out,
                    float* __restrict__ partial, int* __restrict__ arrived,
                    int n_t, int n_d, int rows) {
  extern __shared__ float smem[];
  __shared__ int is_last;
  const int lanes = blockDim.x, groups = blockDim.y;
  const int p = threadIdx.x, g = threadIdx.y;
  const int n_threads = lanes * groups, tid = g * lanes + p;
  const int splits = gridDim.x, split = blockIdx.x, b = blockIdx.y;
  const int t0 = split * rows;
  const int n_rows = min(rows, n_t - t0);
  const int chunks = (n_d + kVec - 1) / kVec;
  // part[(g * kVec + i) * pad + p]: value i of lane p's chunk in group g. A
  // pad of 2 mod 32 makes both the stores (consecutive p) and the reads
  // below (i = d % 16 and p = d / 16 over 32 consecutive d) touch 32
  // distinct banks.
  const int pad = lanes + 2;
  float* part = smem;
  const float* ab = attn2 + (size_t)b * n_t + t0;
  const int8_t* span = q + ((size_t)b * n_t + t0) * n_d;
  float* dst = splits == 1 ? out + (size_t)b * n_d
                           : partial + ((size_t)b * splits + split) * n_d;

  for (int c0 = 0; c0 < chunks; c0 += lanes) {
    const int c = c0 + p;
    const int n_valid = c < chunks ? n_d - c * kVec : 0;
    const int8_t* col = span + c * kVec;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    const int batch = kDepth * groups;  // rows the block takes at once
    int4 cur[kDepth], nxt[kDepth];
    float a_cur[kDepth], a_nxt[kDepth];
    load_weights(a_cur, ab, 0, g, groups, n_rows);
    load_weights(a_nxt, ab, batch, g, groups, n_rows);
    load_rows<kAligned>(cur, col, 0, g, groups, n_rows, n_d, n_valid);
    load_rows<kAligned>(nxt, col, batch, g, groups, n_rows, n_d, n_valid);
    for (int r0 = 0; r0 < n_rows; r0 += batch) {
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (r0 + g + u * groups < n_rows) {  // the same in a warp
          const float a = bf16_round(a_cur[u]);
          ctx_accumulate(acc, cur[u], a, a * kHiScale);
        }
        cur[u] = nxt[u];
        a_cur[u] = a_nxt[u];
      }
      load_weights(a_nxt, ab, r0 + 2 * batch, g, groups, n_rows);
      load_rows<kAligned>(nxt, col, r0 + 2 * batch, g, groups, n_rows, n_d,
                          n_valid);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) part[(g * kVec + i) * pad + p] = acc[i];
    __syncthreads();
    for (int o = tid; o < lanes * kVec; o += n_threads) {
      const int d = c0 * kVec + o;
      if (d < n_d) {
        float s = 0.0f;
        for (int gg = 0; gg < groups; ++gg)
          s += part[(gg * kVec + o % kVec) * pad + o / kVec];
        dst[d] = s;
      }
    }
    __syncthreads();
  }
  if (splits == 1) return;

  // the last block of batch row b to arrive sums the partial rows in order,
  // reading them from L2 (__ldcg) kSumGroup rows at a time
  __syncthreads();
  if (tid == 0) is_last = arrive(arrived + b) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  const float* pb = partial + (size_t)b * splits * n_d;
  float* ob = out + (size_t)b * n_d;
  if (n_d % 4 == 0) {
    const float4* pb4 = reinterpret_cast<const float4*>(pb);
    for (int j = tid; j < n_d / 4; j += n_threads) {
      float4 s = __ldcg(pb4 + j);
      for (int k0 = 1; k0 < splits; k0 += kSumGroup) {
        float4 v[kSumGroup];
#pragma unroll
        for (int u = 0; u < kSumGroup; ++u)
          if (k0 + u < splits)
            v[u] = __ldcg(pb4 + (size_t)(k0 + u) * (n_d / 4) + j);
#pragma unroll
        for (int u = 0; u < kSumGroup; ++u)
          if (k0 + u < splits) {
            s.x += v[u].x;
            s.y += v[u].y;
            s.z += v[u].z;
            s.w += v[u].w;
          }
      }
      reinterpret_cast<float4*>(ob)[j] = s;
    }
  } else {
    for (int d = tid; d < n_d; d += n_threads) {
      float s = __ldcg(pb + d);
      for (int k0 = 1; k0 < splits; k0 += kSumGroup) {
        float v[kSumGroup];
#pragma unroll
        for (int u = 0; u < kSumGroup; ++u)
          if (k0 + u < splits) v[u] = __ldcg(pb + (size_t)(k0 + u) * n_d + d);
#pragma unroll
        for (int u = 0; u < kSumGroup; ++u)
          if (k0 + u < splits) s += v[u];
      }
      ob[d] = s;
    }
  }
  if (tid == 0) arrived[b] = 0;
}

"""
K3_T_RANGES_ENTRY = """__device__ float g_partial[16 * 16 * 4096];
__device__ int g_arrived[1024];

extern "C" int context_int8(const void* attn2, const void* q, void* out,
                            int batch, int n_t, int n_d, int slices,
                            int slice, int lanes_in, int groups_in,
                            void* stream) {
  const int chunks = (n_d + kVec - 1) / kVec;
  const int lanes = min((chunks + 31) / 32 * 32, kLanesMax);
  const int groups = kThreads / lanes;
  const int splits = slices, rows = (n_t + splits - 1) / splits;
  const size_t smem = sizeof(float) * (size_t)groups * kVec * (lanes + 2);
  const bool aligned = n_d % kVec == 0 && aligned16(q);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(aligned ? (const void*)context_rows_kernel<true>
                                 : (const void*)context_rows_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  float* pt;
  int* ar;
  cudaGetSymbolAddress((void**)&pt, g_partial);
  cudaGetSymbolAddress((void**)&ar, g_arrived);
  const dim3 grid(splits, batch), block(lanes, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(attn2);
  const int8_t* t = static_cast<const int8_t*>(q);
  float* o = static_cast<float*>(out);
  if (aligned)
    context_rows_kernel<true><<<grid, block, smem, s>>>(a, t, o, pt, ar, n_t,
                                                        n_d, rows);
  else
    context_rows_kernel<false><<<grid, block, smem, s>>>(a, t, o, pt, ar, n_t,
                                                         n_d, rows);
  return (int)cudaGetLastError();
}

"""
T_RANGES = [("bool aligned16(const void* p) {",
             K3_T_RANGES_KERNEL + "bool aligned16(const void* p) {"),
            (_CTX_ENTRY, K3_T_RANGES_ENTRY)]
_T_LAUNCH = """  if (aligned)
    context_rows_kernel<true><<<grid, block, smem, s>>>(a, t, o, pt, ar, n_t,
                                                        n_d, rows);
  else
    context_rows_kernel<false><<<grid, block, smem, s>>>(a, t, o, pt, ar, n_t,
                                                         n_d, rows);
"""
_T_SMEM = "(size_t)groups * kVec * (lanes + 2);"

CLUSTER = T_RANGES + [
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n#include <cooperative_groups.h>\n"),
    ("""  float* dst = splits == 1 ? out + (size_t)b * n_d
                           : partial + ((size_t)b * splits + split) * n_d;""",
     "  float* dst = part + groups * kVec * pad;  // the block's partial row"),
    (_T_SMEM, "((size_t)groups * kVec * (lanes + 2) + n_d);"),
    (("  if (splits == 1) return;\n", "\nbool aligned16(const void* p) {"),
     """  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (n_d + splits - 1) / splits;
  const int hi = min(n_d, (split + 1) * per);
  for (int d = split * per + tid; d < hi; d += n_threads) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += cluster.map_shared_rank(dst, k)[d];
    out[(size_t)b * n_d + d] = s;
  }
  cluster.sync();
}
"""),
    (_T_LAUNCH, """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      aligned ? cudaLaunchKernelEx(&cfg, context_rows_kernel<true>, a, t, o,
                                   pt, ar, n_t, n_d, rows)
              : cudaLaunchKernelEx(&cfg, context_rows_kernel<false>, a, t, o,
                                   pt, ar, n_t, n_d, rows);
  if (e != cudaSuccess) return (int)e;
""")]

BULK_RING = T_RANGES + [
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n#include \"hopper_async.cuh\"\n"
     "using namespace hopper;\nconstexpr int kStages = 8;\n"),
    ("""  float* part = smem;
  const float* ab = attn2 + (size_t)b * n_t + t0;""", """  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  float* a_s = smem + kStages * groups * n_d / 4;
  float* part = a_s + rows;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int n_stages = (n_rows + groups - 1) / groups;
  const int stage_bytes = groups * n_d;"""),
    (_T_SMEM, "((size_t)groups * kVec * (lanes + 2) + rows + "
              "(size_t)kStages * groups * n_d / 4);"),
    (("    const int batch = kDepth * groups;  // rows the block takes at once\n",
      "#pragma unroll\n    for (int i = 0; i < kVec; ++i) part[(g * kVec + i) * pad + p]"),
     """    if (c0 == 0) {
      if (tid == 0) {
        for (int i = 0; i < kStages; ++i) {
          mbar_init(&full[i], 1);
          mbar_init(&empty[i], n_threads);
        }
        mbar_init_fence();
        for (int st = 0; st < min(kStages, n_stages); ++st) {
          const int nbytes = min(groups, n_rows - st * groups) * n_d;
          mbar_arrive_expect_tx(&full[st], nbytes);
          bulk_load(ring + st * stage_bytes, span + (size_t)st * stage_bytes,
                    nbytes, &full[st]);
        }
      }
      const float* ab = attn2 + (size_t)b * n_t + t0;
      for (int i = tid; i < n_rows; i += n_threads)
        a_s[i] = bf16_round(__ldg(ab + i));
      __syncthreads();
    }
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % kStages;
      const uint32_t parity = (st / kStages) & 1;
      mbar_wait(&full[slot], parity);
      const int r = st * groups + g;
      if (r < n_rows && n_valid > 0)
        ctx_accumulate(acc, *reinterpret_cast<const int4*>(
                                ring + slot * stage_bytes + g * n_d + c * kVec),
                       a_s[r], a_s[r] * kHiScale);
      mbar_arrive(&empty[slot]);
      if (tid == 0 && st + kStages < n_stages) {
        mbar_wait(&empty[slot], parity);
        const int nst = st + kStages;
        const int nbytes = min(groups, n_rows - nst * groups) * n_d;
        fence_proxy_async();
        mbar_arrive_expect_tx(&full[slot], nbytes);
        bulk_load(ring + slot * stage_bytes, span + (size_t)nst * stage_bytes,
                  nbytes, &full[slot]);
      }
    }
""")]

WARP_ROWS = [
    (_K4, """constexpr int kDattnWarps = 6;
constexpr int kDattnChunks = 5;

// grid (splits, B); block kDattnWarps * 32. Each lane holds kChunks chunks
// of bf16(dctx[b]) a pass; a D wider than 32 * kChunks chunks takes passes.
template <bool kAligned, int kChunks>
__global__ void __launch_bounds__(kDattnWarps * 32, 2)
dattn_rows_kernel(const float* __restrict__ dctx,
                  const int8_t* __restrict__ q, float* __restrict__ out,
                  int n_t, int n_d, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x, b = blockIdx.y;
  const int t0 = split * rows;
  const int n_rows = min(rows, n_t - t0);
  const int chunks = (n_d + kVec - 1) / kVec;
  const int8_t* span = q + ((size_t)b * n_t + t0) * n_d;
  const float* gb = dctx + (size_t)b * n_d;
  float* ob = out + (size_t)b * n_t + t0;

  for (int c0 = 0; c0 < chunks; c0 += 32 * kChunks) {
    int n_valid[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = c0 + lane + 32 * k;
      n_valid[k] = c < chunks ? n_d - c * kVec : 0;
    }
    int4 cur[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      cur[k] = load16<kAligned>(
          span + (size_t)warp * n_d + (c0 + lane + 32 * k) * kVec,
          warp < n_rows ? n_valid[k] : 0);
    // the lane's bf16(dctx), the values of bytes 1 and 3 of a word times
    // 2^-8 (see unpack_int8x4), while the first row's loads are in flight
    float gv[kChunks][kVec];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const float* src = gb + (c0 + lane + 32 * k) * kVec;
      if (kAligned && n_valid[k] > 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src) + j);
          gv[k][4 * j + 0] = bf16_round(f.x);
          gv[k][4 * j + 1] = bf16_round(f.y) * kHiScale;
          gv[k][4 * j + 2] = bf16_round(f.z);
          gv[k][4 * j + 3] = bf16_round(f.w) * kHiScale;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          gv[k][i] = i < n_valid[k] ? bf16_round(__ldg(src + i)) *
                                          (i % 2 ? kHiScale : 1.0f)
                                    : 0.0f;
      }
    }
    for (int r = warp; r < n_rows; r += kDattnWarps) {
      const int r_next = r + kDattnWarps;
      int4 nxt[kChunks];
#pragma unroll
      for (int k = 0; k < kChunks; ++k)
        nxt[k] = load16<kAligned>(
            span + (size_t)r_next * n_d + (c0 + lane + 32 * k) * kVec,
            r_next < n_rows ? n_valid[k] : 0);
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int words[4] = {cur[k].x, cur[k].y, cur[k].z, cur[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 x = unpack_int8x4(words[j]);
          s[0] = fmaf(gv[k][4 * j + 0], x.x, s[0]);
          s[1] = fmaf(gv[k][4 * j + 1], x.y, s[1]);
          s[2] = fmaf(gv[k][4 * j + 2], x.z, s[2]);
          s[3] = fmaf(gv[k][4 * j + 3], x.w, s[3]);
        }
        cur[k] = nxt[k];
      }
      float acc = (s[0] + s[1]) + (s[2] + s[3]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) ob[r] = c0 == 0 ? acc : ob[r] + acc;
    }
  }
}

template <bool kAligned>
cudaError_t launch_dattn(int per_lane, dim3 grid, cudaStream_t stream,
                         const float* dctx, const int8_t* q, float* out,
                         int n_t, int n_d, int rows) {
  const dim3 block(kDattnWarps * 32);
  switch (per_lane) {
    case 1: dattn_rows_kernel<kAligned, 1><<<grid, block, 0, stream>>>(
        dctx, q, out, n_t, n_d, rows); break;
    case 2: dattn_rows_kernel<kAligned, 2><<<grid, block, 0, stream>>>(
        dctx, q, out, n_t, n_d, rows); break;
    case 3: dattn_rows_kernel<kAligned, 3><<<grid, block, 0, stream>>>(
        dctx, q, out, n_t, n_d, rows); break;
    case 4: dattn_rows_kernel<kAligned, 4><<<grid, block, 0, stream>>>(
        dctx, q, out, n_t, n_d, rows); break;
    default: dattn_rows_kernel<kAligned, kDattnChunks>
        <<<grid, block, 0, stream>>>(dctx, q, out, n_t, n_d, rows);
  }
  return cudaGetLastError();
}

"""),
    (_DATTN_ENTRY, """extern "C" int dattn_int8(const void* dctx, const void* q, void* out,
                          int batch, int n_t, int n_d, int splits, int rows,
                          int lanes, int groups, void* stream) {
  const int slots = ((n_d + kVec - 1) / kVec + 31) / 32;
  const int passes = (slots + kDattnChunks - 1) / kDattnChunks;
  const int per_lane = (slots + passes - 1) / passes;
  const bool aligned = n_d % kVec == 0 && aligned16(q) && aligned16(dctx);
  const dim3 grid(splits, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dctx);
  const int8_t* t = static_cast<const int8_t*>(q);
  float* o = static_cast<float*>(out);
  return (int)(aligned ? launch_dattn<true>(per_lane, grid, s, g, t, o, n_t,
                                            n_d, rows)
                       : launch_dattn<false>(per_lane, grid, s, g, t, o, n_t,
                                             n_d, rows));
}
""")]


def _stamp(k, i):
    return ("{{ if (threadIdx.x == 0 && threadIdx.y == 0) {{ "
            "unsigned long long t; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
            "const int blk = blockIdx.y * gridDim.x + blockIdx.x; "
            "if (blk < 1024) {{ g_stamps[{k}][blk][{i}] = t; "
            "g_stamps[{k}][blk][8 + {i}] = clock64(); }} }} }}\n").format(
                k=k, i=i)


# time stamps (the global timer and the SM's clock) of thread 0 of each
# block at the ends of the phases of K3 and K4 (entry, first batch, main
# loop or end)
STAMPS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long "
                     "g_stamps[2][1024][16];\n"),
    ("  float* ob = out + (size_t)b * n_d;\n",
     "  float* ob = out + (size_t)b * n_d;\n" + _stamp(0, 0)),
    ("      load_weights(a_nxt, ab, r0 + 2 * batch, g, groups, n_t);\n",
     "      if (r0 == 0) " + _stamp(0, 1)
     + "      load_weights(a_nxt, ab, r0 + 2 * batch, g, groups, n_t);\n"),
    ("    for (int i = 0; i < kVec; ++i) part[tid * (kVec + 1) + i] = acc[i];\n"
     "    __syncthreads();\n",
     "    for (int i = 0; i < kVec; ++i) part[tid * (kVec + 1) + i] = acc[i];\n"
     "    __syncthreads();\n" + _stamp(0, 2)),
    ("        ob[d] = (s0 + s1) + (s2 + s3);\n      }\n    }\n    __syncthreads();\n  }\n",
     "        ob[d] = (s0 + s1) + (s2 + s3);\n      }\n    }\n    __syncthreads();\n  }\n"
     + _stamp(0, 3)),
    ("  float* ob = out + (size_t)b * n_t + t0;\n",
     "  float* ob = out + (size_t)b * n_t + t0;\n" + _stamp(1, 0)),
    ("                          n_valid);\n      __syncthreads();\n",
     "                          n_valid);\n      __syncthreads();\n"
     "      if (r0 == 0) " + _stamp(1, 1)),
    ("    __syncthreads();\n  }\n}\n\nbool aligned16",
     "    __syncthreads();\n  }\n" + _stamp(1, 2) + "}\n\nbool aligned16"),
    ("extern \"C\" int dattn_int8(",
     "extern \"C\" int read_stamps(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n\n"
     "extern \"C\" int dattn_int8("),
]

# the variants read at another number of parts than the rules'
PARTS = {"parts9": 9, "parts16": 16}
VARIANTS = {
    "as built": [],
    "i2f": [(_UNPACK, """  const int s = word;
  return make_float4((float)((s << 24) >> 24), (float)(((s << 16) >> 24) << 8),
                     (float)((s << 8) >> 24), (float)((s >> 24) << 8));""")],
    "prmt": [(_UNPACK, """  const unsigned f = (unsigned)word ^ 0x80808080u;
  return make_float4(
      __uint_as_float(__byte_perm(f, 0x4B000000u, 0x7650)) - kMagicLo,
      __uint_as_float(__byte_perm(f, 0x4B000000u, 0x7614)) - kMagicHi,
      __uint_as_float(__byte_perm(f, 0x4B000000u, 0x7652)) - kMagicLo,
      __uint_as_float(__byte_perm(f, 0x4B000000u, 0x7634)) - kMagicHi);""")],
    "depth2": [("constexpr int kDepth = 4;", "constexpr int kDepth = 2;")],
    "depth8": [("constexpr int kDepth = 4;", "constexpr int kDepth = 8;")],
    "parts9": [],
    "parts16": [],
    "k3_t_ranges": T_RANGES,
    "k3_t_ranges_cluster": CLUSTER,
    "k3_t_ranges_bulk_ring": BULK_RING,
    "k4_warp_rows": WARP_ROWS,
    "empty": [("  extern __shared__ float part[];\n",
               "  extern __shared__ float part[];\n  if (n_d > 0) return;\n"),
              ("  extern __shared__ float prod[];\n",
               "  extern __shared__ float prod[];\n  if (n_d > 0) return;\n")],
    "no_loads": [("""    return n_valid > 0 ? __ldg(reinterpret_cast<const int4*>(p))
                       : make_int4(0, 0, 0, 0);""",
                  """    return n_valid > 0 ? make_int4(n_valid, (int)(size_t)p, 3, 5)
                       : make_int4(0, 0, 0, 0);""")],
    "loads_only": [("    const float4 x = unpack_int8x4(words[j]);\n" + _CTX_FMA,
                    "    acc[j] += a * __int_as_float(words[j]) + a_hi;"),
                   ("    const float4 x = unpack_int8x4(words[j]);\n" + _DOT_FMA,
                    "    s[j] += g[j] * __int_as_float(words[j]);")],
    "stamps": STAMPS,
}


def _patched(patches):
    """The source with each (old, new) patch applied in turn."""
    src = open(os.path.join(CSRC, "int8_table.cu")).read()
    for old, new in patches:
        if isinstance(old, tuple):
            lo = src.index(old[0])
            hi = len(src) if old[1] is None else src.index(old[1], lo)
            src = src[:lo] + new + src[hi:]
            continue
        if old not in src:
            raise RuntimeError("the source no longer has: " + old[:60])
        src = src.replace(old, new)
    return src


def _build(name, patches):
    """(the loaded copy, its path, ptxas's lines on registers and spills)."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import build
    os.makedirs(OUT, exist_ok=True)
    tag = name.replace(" ", "_")
    path = os.path.join(OUT, "int8_table_{}.cu".format(tag))
    with open(path, "w") as f:
        f.write(_patched(patches))
    lib = os.path.join(OUT, "lib_{}.so".format(tag))
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-I", CSRC, "-o", lib, path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-3000:])
    regs = []
    for line in res.stderr.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            kern = re.search(r"(context|dattn)_int8_kernelILb(\d)E(?:Li(\d))?",
                             m.group(1))
            regs.append([kern.group(0) if kern else m.group(1)[:40]])
        elif regs and ("registers" in line or "spill" in line):
            regs[-1].append(line.split(":", 1)[-1].strip())
    out = ctypes.CDLL(lib)
    for fn in (out.context_int8, out.dattn_int8):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    out.context_int8.restype = out.dattn_int8.restype = ctypes.c_int
    return out, lib, regs


def _sass_counts(lib):
    """Static opcode counts of each kernel in ``lib`` (cuobjdump -sass)."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    lines = []
    for part in re.split(r"\n\s*Function : ", txt)[1:]:
        name = part.split("\n", 1)[0].strip()
        kern = re.search(r"(context|dattn)_int8_kernelILb(\d)E(?:Li(\d))?",
                         name)
        ops = [o.split(".")[0] for o in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            part)]
        c = collections.Counter(ops)
        lines.append("{}: {} instructions, {}".format(
            kern.group(0) if kern else name[:60], len(ops), ", ".join(
                "{} {}".format(op, c[op]) for op in (
                    "FFMA", "PRMT", "FADD", "I2F", "I2FP", "SHF", "LOP3",
                    "LDG", "LDS", "STS", "IMAD", "ISETP", "SEL", "F2F",
                    "BRA"))))
    return lines


def _print_stamps(lib, Q, a2, q, dctx):
    """One launch of each kernel with a warm L2 and one with a cold one,
    through the stamped copy: each phase's end over the blocks."""
    import numpy as np
    import torch
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    buf = np.zeros((2, 1024, 16), dtype=np.uint64)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=q.device)
    n_sm = Q._sm_count(q.device.index)
    n_blocks = [rule(*q.shape, n_sm).parts * q.shape[0]
                for rule in (Q.ctx_grid, Q.dattn_grid)]
    phases = {0: ("entry", "first batch", "main loop", "end"),
              1: ("entry", "first batch", "end")}
    for state in ("warm", "cold"):
        for k, (fn, small) in enumerate(((Q.context_int8, a2),
                                         (Q.dattn_int8, dctx))):
            fn(small, q)
            if state == "cold":
                flush.fill_(1)
            torch.cuda.synchronize()
            buf[:] = 0
            fn(small, q)
            torch.cuda.synchronize()
            if lib.read_stamps(buf.ctypes.data) != 0:
                raise RuntimeError("read_stamps failed")
            st = buf[k, :n_blocks[k]].astype(np.int64)
            t0 = st[:, 0].min()
            names = phases[k]
            ends = []
            for i, ph in enumerate(names):
                col = st[:, i]
                col = col[col > 0]
                if col.size:
                    ends.append("{} {:.2f}/{:.2f}".format(
                        ph, (np.median(col) - t0) / 1e3, (col.max() - t0) / 1e3))
            last = len(names) - 1
            done = (st[:, last] > 0)
            ghz = ((st[done, 8 + last] - st[done, 8]) /
                   np.maximum(st[done, last] - st[done, 0], 1)).mean()
            print("stamps {} {}: us from the first entry, median/largest over "
                  "{} blocks: {}; SM clock {:.2f} GHz".format(
                      ("K3", "K4")[k], state, n_blocks[k], ", ".join(ends),
                      ghz),
                  flush=True)


def _cut(grid, n, parts):
    """``grid`` with its n chunks or rows cut into ``parts`` parts."""
    size = -(-n // parts)
    lanes = min(grid.lanes, size) if grid.lanes % 32 else grid.lanes
    return grid._replace(parts=-(-n // size), size=size, lanes=lanes,
                         groups=512 // lanes)


def _readings():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_readings", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_parts(Q, a2, q, dctx, cs):
    """The wrapper's host time a call, and its parts alone."""
    import torch
    dev = q.device
    b, t, d = q.shape
    lib = Q._library()
    out = torch.empty(b, d, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (a2.data_ptr(), q.data_ptr(), out.data_ptr(), b, t, d,
            *Q.ctx_grid(b, t, d, Q._sm_count(dev.index)), stream)
    parts = {
        "context_int8 (all of it)": lambda: Q.context_int8(a2, q),
        "dattn_int8 (all of it)": lambda: Q.dattn_int8(dctx, q),
        "_check": lambda: Q._check(a2, q, 1, "attn2"),
        "_on_card": lambda: Q._on_card(q, "context_int8"),
        "q.get_device": q.get_device,
        "casts and contiguity tests": lambda: (
            a2.dtype != torch.float32 or not a2.is_contiguous(),
            q.is_contiguous()),
        "ctx_grid + _sm_count": lambda: Q.ctx_grid(
            b, t, d, Q._sm_count(dev.index)),
        "torch.empty of the output": lambda: torch.empty(
            b, d, dtype=torch.float32, device=dev),
        "torch.cuda.current_device": torch.cuda.current_device,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "three data_ptr calls": lambda: (a2.data_ptr(), q.data_ptr(),
                                         out.data_ptr()),
        "the ctypes call (launches K3)": lambda: lib.context_int8(*args),
    }
    return ["{} {:.2f} us".format(k, cs._host_ms(fn, 200) * 1e3)
            for k, fn in parts.items()]


def _sass_tokens(source):
    """The instructions nvcc makes of ``source`` (the package's flags),
    without addresses, encodings or the file-dependent kernel names."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import build
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "sass_{}.so".format(abs(hash(source))))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, source],
                   check=True, capture_output=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    return [re.sub(r"_GLOBAL__N__\w+?_cu_\w+?(?=\d+\w)", "ANON", m)
            for m in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", txt)]


def same_sass(other, names):
    """Whether each csrc/<name>.cu of this checkout and of ``other`` (say an
    unpacked parent commit) compile to the same instructions."""
    for name in names:
        rel = os.path.join("e2e_asr_pytorch_tpu_torch", "csrc", name + ".cu")
        mine = _sass_tokens(os.path.join(ROOT, rel))
        theirs = _sass_tokens(os.path.join(os.path.abspath(other), rel))
        diff = sum(a != b for a, b in zip(mine, theirs)) + abs(
            len(mine) - len(theirs))
        print("SASS of {} here and in {}: {} instructions, {}".format(
            rel, other, len(mine), "identical" if diff == 0 else
            "{} differ".format(diff)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names (default: all)")
    ap.add_argument("--same-sass", metavar="DIR",
                    help="only compare the machine code of the other "
                    "kernels' sources with DIR's")
    args = ap.parse_args(argv)
    if args.same_sass:
        same_sass(args.same_sass, ("bilstm_fwd", "bilstm_bwd", "lstm_fwd",
                                   "lstm_bwd", "gru", "ligru"))
        return 0
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs = _readings()
    print(cs._nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(10)
    b, t, d = SHAPE
    values = torch.tanh(1.2 * torch.randn(b, t, d, generator=gen)).to(dev)
    q, scale = Q.quantize_table(values)
    a2 = torch.softmax(torch.randn(b, t, generator=gen), -1).to(dev) * scale
    dctx = (0.1 * torch.randn(b, d, generator=gen)).to(dev)
    refs = (Q.context_int8_ref(a2, q), Q.dattn_int8_ref(dctx, q))
    sound = Q._library, Q.ctx_grid, Q.dattn_grid
    built = {}
    for name in args.variants.split(","):
        lib, path, regs = _build(name, VARIANTS[name])
        built[name] = path
        Q._library = lambda lib=lib: lib
        if name in PARTS:
            n = PARTS[name]
            Q.ctx_grid = lambda b, t, d, n_sm, n=n: _cut(sound[1](
                b, t, d, n_sm), -(-d // Q.VEC), n)
            Q.dattn_grid = lambda b, t, d, n_sm, n=n: _cut(sound[2](
                b, t, d, n_sm), t, n)
        try:
            outs = (Q.context_int8(a2, q), Q.dattn_int8(dctx, q))
            torch.cuda.synchronize()
            errs = [((o - r).abs().max() / r.abs().max()).item()
                    for o, r in zip(outs, refs)]
            times = []
            for fn, small in ((Q.context_int8, a2), (Q.dattn_int8, dctx)):
                times.append(cs._time_ms(lambda: fn(small, q), 200))
                times.append(cs._cold_ms(lambda: fn(small, q), 50))
            if name == "stamps":
                _print_stamps(lib, Q, a2, q, dctx)
        finally:
            Q._library, Q.ctx_grid, Q.dattn_grid = sound
        print("{}: K3 warm {:.5f} ms, cold {:.5f} ms, rel err {:.2e}; K4 "
              "warm {:.5f} ms, cold {:.5f} ms, rel err {:.2e}; ptxas: {}"
              .format(name, times[0], times[1], errs[0], times[2], times[3],
                      errs[1], "; ".join(" ".join(r) for r in regs)),
              flush=True)
    for name in ("as built", "i2f", "prmt"):
        if name in built:
            for line in _sass_counts(built[name]):
                print("SASS {}: {}".format(name, line), flush=True)
    print("host a call: " + "; ".join(_host_parts(Q, a2, q, dctx, cs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
