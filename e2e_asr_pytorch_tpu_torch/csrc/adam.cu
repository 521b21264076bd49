// Adam's update of every leaf of a parameter tree in one launch, for Hopper
// (sm_90a): the optimizer step of train/optim.py's Adam and AdamW.
//
//   g   = clip_active ? g / gnorm * grad_clip : g
//   mu' = (1 - b1) g + b1 mu
//   nu' = (1 - b2) (g g) + b2 nu
//   u   = (mu' / corr1) / (sqrt(nu' / corr2) + eps)   [+ weight_decay p]
//   p'  = p + step_size u
//
// stored, every one of p, mu, nu, only when the gradients' global norm is
// finite (ok). The arithmetic is the per-leaf chain of eager PyTorch ops
// that train/optim.py runs (the frame's _update with Adam._leaf and
// AdamW._leaf) off the card, op for op in its order
// and each op rounded where that chain rounds it (one f32 rounding an op,
// the state rounded to nearest even on its store in bf16): the __f*_rn
// intrinsics keep the compiler from contracting a product and a sum into
// an FMA, which would change the bits. So a launch gives the chain's bits.
//
// Replaces no TPU kernel: the JAX package leaves optax's chain to XLA's
// fusion. What bounds it on the H100 is bytes: a parameter reads p, g, mu
// and nu and writes p, mu and nu once each, 28 bytes at f32 state and 20
// at bf16, some 3.8 GB and 1.1 ms at 3.35 TB/s for the 134M parameters of
// the 4x LSTM-2048 LM, and the operations (a dozen f32 ones a parameter)
// are far under the card's rate. The eager chain moves each leaf through
// some twenty kernels, each reading and writing whole f32 tensors. The
// design moves each byte once:
//
//  * One launch covers every leaf of one state dtype (the parameters and
//    gradients are f32, Adam's master weights everywhere): the leaves'
//    pointers and sizes travel by value in the kernel's parameters
//    (Table), so a step copies nothing to the card and the gradients,
//    which autograd allocates anew every step, need no cached table.
//  * Each leaf is cut into chunks of `chunk` elements; chunk c belongs to
//    the leaf l with chunk_end[l - 1] <= c < chunk_end[l] (the planner is
//    ops/kernels/adam.py plan_chunks). A block walks the chunks
//    blockIdx.x, blockIdx.x + gridDim.x, ..., one wave of blocks filling
//    every SM; no chunk crosses a leaf.
//  * A thread loads and stores 4 elements of each stream at a time (16
//    bytes of an f32 stream, 8 of a bf16 one) on a leaf whose four
//    streams are so aligned; the last chunk's remainder, and a leaf that
//    is not aligned, go element by element.
//  * The six scalars of the step (gnorm, ok, clip_active, step_size, corr1,
//    corr2) are 0-dim device tensors read by pointer: none comes to the
//    host. No sums, no atomics: every launch gives the same bits.
//
// Plain C interface, loaded with ctypes (see ops/kernels/adam.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // elements a thread moves at a time
constexpr int kMaxLeaves = 64;   // leaves a launch (the table's rows)

struct Leaf {
  void* p;
  const void* g;
  void* mu;
  void* nu;
  long long n;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int chunk_end[kMaxLeaves];  // chunks of leaves 0..l together
};

struct Scalars {
  const float* gnorm;
  const bool* ok;
  const bool* clip_active;
  const float* step_size;
  const float* corr1;
  const float* corr2;
};

struct Consts {
  float grad_clip, b1c, b1, b2c, b2, eps, weight_decay;
  int decay;  // AdamW: u + weight_decay p (Adam: no such op)
};

// the step's scalars as each element reads them
struct Step {
  bool clip;
  float gnorm, step_size, corr1, corr2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One element: p, mu, nu updated in place (as f32; the caller stores).
__device__ __forceinline__ void adam_element(float& p, float g, float& mu,
                                             float& nu, const Step& s,
                                             const Consts& c) {
  if (s.clip) g = __fmul_rn(__fdiv_rn(g, s.gnorm), c.grad_clip);
  mu = __fadd_rn(__fmul_rn(c.b1c, g), __fmul_rn(c.b1, mu));
  nu = __fadd_rn(__fmul_rn(c.b2c, __fmul_rn(g, g)), __fmul_rn(c.b2, nu));
  float u = __fdiv_rn(__fdiv_rn(mu, s.corr1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, s.corr2)), c.eps));
  if (c.decay) u = __fadd_rn(u, __fmul_rn(c.weight_decay, p));
  p = __fadd_rn(p, __fmul_rn(s.step_size, u));
}

// kVec elements of a stream at x (aligned to kVec elements) as f32, and back
__device__ __forceinline__ void load4(const float* x, float (&v)[kVec]) {
  const float4 w = *reinterpret_cast<const float4*>(x);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* x,
                                      float (&v)[kVec]) {
  const uint2 w = *reinterpret_cast<const uint2*>(x);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const
                                      __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const
                                      __nv_bfloat162*>(&w.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* x, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(x) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* x,
                                       const float (&v)[kVec]) {
  __nv_bfloat162 a, b;
  a.x = __float2bfloat16_rn(v[0]); a.y = __float2bfloat16_rn(v[1]);
  b.x = __float2bfloat16_rn(v[2]); b.y = __float2bfloat16_rn(v[3]);
  uint2 w;
  w.x = *reinterpret_cast<unsigned*>(&a);
  w.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(x) = w;
}

template <typename T>
__device__ __forceinline__ bool aligned_vec(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % (kVec * sizeof(T)) == 0;
}

// TS: the state's type (float or bf16); the parameters and gradients f32
template <typename TS>
__global__ void __launch_bounds__(kThreads)
    adam_multi_tensor_kernel(const __grid_constant__ Table t, int n_chunks,
                             int chunk, Scalars sc, Consts c) {
  if (!*sc.ok) return;  // a non-finite norm: nothing is stored
  const Step s{*sc.clip_active, *sc.gnorm, *sc.step_size, *sc.corr1,
               *sc.corr2};
  int l = 0;
  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    while (ch >= t.chunk_end[l]) ++l;
    const long long off =
        (long long)(ch - (l ? t.chunk_end[l - 1] : 0)) * chunk;
    const int len = (int)min((long long)chunk, t.leaf[l].n - off);
    float* p = static_cast<float*>(t.leaf[l].p) + off;
    const float* g = static_cast<const float*>(t.leaf[l].g) + off;
    TS* mu = static_cast<TS*>(t.leaf[l].mu) + off;
    TS* nu = static_cast<TS*>(t.leaf[l].nu) + off;
    int scalar_from = 0;
    if (aligned_vec<float>(p) && aligned_vec<float>(g) &&
        aligned_vec<TS>(mu) && aligned_vec<TS>(nu)) {
      const int n_vec = len / kVec * kVec;
      for (int i = threadIdx.x * kVec; i < n_vec; i += kThreads * kVec) {
        float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
        load4(p + i, pv);
        load4(g + i, gv);
        load4(mu + i, mv);
        load4(nu + i, vv);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          adam_element(pv[j], gv[j], mv[j], vv[j], s, c);
        store4(mu + i, mv);
        store4(nu + i, vv);
        store4(p + i, pv);
      }
      scalar_from = n_vec;
    }
    for (int i = scalar_from + threadIdx.x; i < len; i += kThreads) {
      float pe = p[i], me = to_f32(mu[i]), ve = to_f32(nu[i]);
      adam_element(pe, g[i], me, ve, s, c);
      mu[i] = from_f32<TS>(me);
      nu[i] = from_f32<TS>(ve);
      p[i] = pe;
    }
  }
}

template <typename TS>
int launch(const Table& t, int n_chunks, int chunk, const Scalars& sc,
           const Consts& c, cudaStream_t stream) {
  static int per_sm = 0;  // blocks an SM holds, read once
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adam_multi_tensor_kernel<TS>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int blocks = n_chunks < sms * per_sm ? n_chunks : sms * per_sm;
  adam_multi_tensor_kernel<TS>
      <<<blocks, kThreads, 0, stream>>>(t, n_chunks, chunk, sc, c);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over n_leaves leaves. rows: n_leaves rows of six int64s, (p, g,
// mu, nu, numel, chunk_end) with the pointers as integers, p and g f32;
// state_bf16 selects the state's type; the scalars are device pointers;
// chunk a multiple of 4. Returns a cudaError_t (0 on success).
extern "C" int adam_update(int n_leaves, const long long* rows, int chunk,
                           int state_bf16,
                           const void* gnorm, const void* ok,
                           const void* clip_active, const void* step_size,
                           const void* corr1, const void* corr2,
                           float grad_clip, float b1c, float b1, float b2c,
                           float b2, float eps, int decay,
                           float weight_decay, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || chunk < kVec ||
      chunk % kVec != 0)
    return (int)cudaErrorInvalidValue;
  Table t;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* r = rows + 6 * l;
    t.leaf[l] = Leaf{reinterpret_cast<void*>(r[0]),
                     reinterpret_cast<const void*>(r[1]),
                     reinterpret_cast<void*>(r[2]),
                     reinterpret_cast<void*>(r[3]), r[4]};
    t.chunk_end[l] = (int)r[5];
  }
  const int n_chunks = t.chunk_end[n_leaves - 1];
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  for (int l = n_leaves; l < kMaxLeaves; ++l) {
    t.leaf[l] = Leaf{nullptr, nullptr, nullptr, nullptr, 0};
    t.chunk_end[l] = n_chunks;
  }
  const Scalars sc{static_cast<const float*>(gnorm),
                   static_cast<const bool*>(ok),
                   static_cast<const bool*>(clip_active),
                   static_cast<const float*>(step_size),
                   static_cast<const float*>(corr1),
                   static_cast<const float*>(corr2)};
  const Consts c{grad_clip, b1c, b1, b2c, b2, eps, weight_decay, decay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return state_bf16 ? launch<__nv_bfloat16>(t, n_chunks, chunk, sc, c, s)
                    : launch<float>(t, n_chunks, chunk, sc, c, s);
}
