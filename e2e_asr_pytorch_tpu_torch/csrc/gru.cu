// GRU recurrence for Hopper (sm_90a), forward and backward, gate order
// r,z,n with two bias vectors as torch.nn.GRU has them.
//
// gru_fwd replaces `_fwd_kernel` / `_fwd` and gru_bwd `_bwd_kernel` / `_bwd`
// of e2e_asr_pytorch_tpu/ops/pallas/gru.py. From a zero state, per step
//
//     hg = bf16(h_prev) @ bf16(w_h) + b_h                 (f32 sums)
//     r  = sigmoid(xg_r + hg_r) ;  z = sigmoid(xg_z + hg_z)
//     n  = tanh(xg_n + r * hg_n)          (b_h's n part is inside the r gate)
//     h  = (1 - z) * n + z * h_prev                        (h carried in f32)
//
// with xg = x @ W_x + b_x formed outside. The forward writes ys in xg's
// dtype and, unless its pointer is null, the bf16 stash of hg (b_h
// included). The backward re-forms r, z, n from xg and that bf16 stash, takes
// h_prev from the bf16 hidden stream one scan step earlier, and per step
//
//     dh  = dy[t] + (dh_prev * z_prev + bf16(dhg_prev) @ bf16(w_h)^T)
//     dz  = dh * (h_prev - n) ;  dn = dh * (1 - z) ;  dxn = dn * (1 - n^2)
//     dxr = dxn * hg_n * r * (1 - r) ;  dxz = dz * z * (1 - z)
//     dxg[t] = [dxr, dxz, dxn]   (xg's dtype)
//     dhg[t] = [dxr, dxz, dxn * r]   (f32; the two differ in the n slot)
//
// dW_h, db_h, dW_x, db_x and dx are products and sums outside the kernel
// (ops/kernels/gru.py). Each has two forms: gru_fwd_packed and
// gru_bwd_packed walk both directions of a bidirectional layer in one
// launch, gru_fwd and gru_bwd one direction. Design and bound:
// gru_common.cuh.
//
// Plain C interface, loaded with ctypes.

#include "gru_common.cuh"

namespace {

using namespace rec;

struct GruCell {
  static constexpr int NG = 3;

  static __device__ __forceinline__ float forward(const float* x,
                                                  const float* hg, float h_prev,
                                                  float /*mask*/) {
    const float r = sigmoid_f(x[0] + hg[0]);
    const float z = sigmoid_f(x[1] + hg[1]);
    const float n = tanhf(x[2] + r * hg[2]);
    return (1.0f - z) * n + z * h_prev;
  }

  static __device__ __forceinline__ float backward(const float* x,
                                                   const float* hg,
                                                   float h_prev, float /*mask*/,
                                                   float dh, float* dx,
                                                   float* dhh) {
    const float r = sigmoid_f(x[0] + hg[0]);
    const float z = sigmoid_f(x[1] + hg[1]);
    const float n = tanhf(x[2] + r * hg[2]);
    const float dz = dh * (h_prev - n);
    const float dn = dh * (1.0f - z);
    const float dxn = dn * (1.0f - n * n);
    const float dr = dxn * hg[2];
    dx[0] = dhh[0] = dr * r * (1.0f - r);
    dx[1] = dhh[1] = dz * z * (1.0f - z);
    dx[2] = dxn;
    dhh[2] = dxn * r;
    return z;
  }
};

}  // namespace

// Each returns a cudaError_t code (0 on success). is_bf16 selects the dtype
// of the xg / ys / dy / dxg streams (1: bf16, 0: f32). `hidden` must be a
// multiple of 16, of 80 for the packed form (the wrapper pads with units
// whose weights, biases and inputs are zero). All pointers come from fresh
// PyTorch allocations (256-byte aligned).
//
// gru_fwd: xg (T,B,3H); wp (H/16, 48, H) bf16 packed w_h (gru_common.cuh);
// b_h (3H) f32; ys (T,B,H); hgs (T,B,3H) bf16 or null; hbuf (2,B,H) bf16 with
// buffer 0 zeroed; hcar (B,H) f32 zeroed.
extern "C" int gru_fwd(const void* xg, const void* wp, const void* b_h,
                       void* ys, void* hgs, void* hbuf, void* hcar,
                       int n_steps, int batch, int hidden, int reverse,
                       int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<bf16, GruCell>(xg, wp, b_h, nullptr, ys, hgs, hbuf, hcar,
                                     n_steps, batch, hidden, reverse, st);
  return launch_fwd<float, GruCell>(xg, wp, b_h, nullptr, ys, hgs, hbuf, hcar,
                                    n_steps, batch, hidden, reverse, st);
}

// gru_fwd_packed: both directions in one launch, the forward one on xg_f
// (t = 0..T-1), the backward one on xg_b (t = T-1..0), each (T,B,3H); wp
// (2, H/20, 64, H) bf16 packed w_h of both (gru_common.cuh); b_h (2, 3H)
// f32; ys_* (T,B,H); hgs_* (T,B,3H) bf16 or both null; hbuf (2,2,B,H) bf16
// with buffer 0 of each direction zeroed; hcar (2,B,H) f32 zeroed. `hidden`
// must be a multiple of 80.
extern "C" int gru_fwd_packed(const void* xg_f, const void* xg_b,
                              const void* wp, const void* b_h, void* ys_f,
                              void* ys_b, void* hgs_f, void* hgs_b,
                              void* hbuf, void* hcar, int n_steps, int batch,
                              int hidden, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_packed_fwd<bf16, GruCell>(xg_f, xg_b, wp, b_h, nullptr,
                                            ys_f, ys_b, hgs_f, hgs_b, hbuf,
                                            hcar, n_steps, batch, hidden, st);
  return launch_packed_fwd<float, GruCell>(xg_f, xg_b, wp, b_h, nullptr,
                                           ys_f, ys_b, hgs_f, hgs_b, hbuf,
                                           hcar, n_steps, batch, hidden, st);
}

// gru_bwd: xg (T,B,3H); wh (H,3H) bf16; hgs (T,B,3H) bf16; ys (T,B,H) bf16;
// dy (T,B,H); dxg (T,B,3H); dhg (T,B,3H) f32; xbuf (2,B,3H) bf16; dhz (B,H)
// f32 zeroed.
extern "C" int gru_bwd(const void* xg, const void* wh, const void* hgs,
                       const void* ys, const void* dy, void* dxg, void* dhg,
                       void* xbuf, void* dhz, int n_steps, int batch,
                       int hidden, int reverse, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<bf16, GruCell>(xg, wh, nullptr, hgs, ys, dy, dxg, dhg,
                                     xbuf, dhz, n_steps, batch, hidden,
                                     reverse, st);
  return launch_bwd<float, GruCell>(xg, wh, nullptr, hgs, ys, dy, dxg, dhg,
                                    xbuf, dhz, n_steps, batch, hidden, reverse,
                                    st);
}

// gru_bwd_packed: both directions' backward in one launch, the forward one
// on the *_f operands (t = T-1..0), the backward one on the *_b operands
// (t = 0..T-1), each laid out as gru_bwd's; xbuf (2,2,B,3H) bf16; dhz
// (2,B,H) f32 zeroed. `hidden` must be a multiple of 80.
extern "C" int gru_bwd_packed(const void* xg_f, const void* xg_b,
                              const void* wh_f, const void* wh_b,
                              const void* hgs_f, const void* hgs_b,
                              const void* ys_f, const void* ys_b,
                              const void* dy_f, const void* dy_b, void* dxg_f,
                              void* dxg_b, void* dhg_f, void* dhg_b,
                              void* xbuf, void* dhz, int n_steps, int batch,
                              int hidden, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_packed_bwd<bf16, GruCell>(
        xg_f, xg_b, wh_f, wh_b, nullptr, hgs_f, hgs_b, ys_f, ys_b, dy_f, dy_b,
        dxg_f, dxg_b, dhg_f, dhg_b, xbuf, dhz, n_steps, batch, hidden, st);
  return launch_packed_bwd<float, GruCell>(
      xg_f, xg_b, wh_f, wh_b, nullptr, hgs_f, hgs_b, ys_f, ys_b, dy_f, dy_b,
      dxg_f, dxg_b, dhg_f, dhg_b, xbuf, dhz, n_steps, batch, hidden, st);
}
