// Light-GRU recurrence for Hopper (sm_90a), forward and backward, gate
// order z,a (update gate, candidate).
//
// ligru_fwd replaces `_fwd_kernel` / `_fwd` and ligru_bwd `_bwd_kernel` /
// `_bwd` of e2e_asr_pytorch_tpu/ops/pallas/ligru.py. From a zero state, per
// step
//
//     hg   = bf16(h_prev) @ bf16(w_h)                      (f32 sums)
//     z    = sigmoid(xg_z + hg_z)
//     cand = relu(xg_a + hg_a) * mask
//     h    = z * h_prev + (1 - z) * cand                  (h carried in f32)
//
// where xg is the batch-normalised input projection, formed outside, and
// mask the (B,H) recurrent dropout mask shared by every step (ones outside
// training). The forward writes ys in xg's dtype and, unless its pointer is
// null, the bf16 stash of hg. The backward re-forms z and a from xg and that
// bf16 stash, takes h_prev from the bf16 hidden stream one scan step
// earlier, and per step
//
//     dh   = dy[t] + (dh_prev * z_prev + bf16(dxg_prev) @ bf16(w_h)^T)
//     dz   = dh * (h_prev - cand) ;  dcand = dh * (1 - z)
//     dxg[t] = [dz * z * (1 - z), dcand * mask * (a > 0)]   (xg's dtype)
//
// where the product's operand is rounded from the f32 dxg, not from the
// emitted one. dW_h, the batch norm's gradient, dW_x and dx are formed
// outside the kernel (ops/kernels/ligru.py, autograd). Each has two forms:
// ligru_fwd_packed and ligru_bwd_packed walk both directions of a
// bidirectional layer in one launch, ligru_fwd and ligru_bwd one direction.
// Design and bound: gru_common.cuh. The candidates are not bounded by 1 as
// an LSTM's or a GRU's h is: |h| grows with the inputs.
//
// Plain C interface, loaded with ctypes.

#include "gru_common.cuh"

namespace {

using namespace rec;

struct LiGruCell {
  static constexpr int NG = 2;

  static __device__ __forceinline__ float forward(const float* x,
                                                  const float* hg, float h_prev,
                                                  float mask) {
    const float z = sigmoid_f(x[0] + hg[0]);
    const float cand = fmaxf(x[1] + hg[1], 0.0f) * mask;
    return z * h_prev + (1.0f - z) * cand;
  }

  static __device__ __forceinline__ float backward(const float* x,
                                                   const float* hg,
                                                   float h_prev, float mask,
                                                   float dh, float* dx,
                                                   float* dhh) {
    const float z = sigmoid_f(x[0] + hg[0]);
    const float a = x[1] + hg[1];
    const float cand = fmaxf(a, 0.0f) * mask;
    const float dz = dh * (h_prev - cand);
    const float dcand = dh * (1.0f - z);
    dx[0] = dhh[0] = dz * z * (1.0f - z);
    dx[1] = dhh[1] = a > 0.0f ? dcand * mask : 0.0f;
    return z;
  }
};

}  // namespace

// Each returns a cudaError_t code (0 on success). is_bf16 selects the dtype
// of the xg / ys / dy / dxg streams (1: bf16, 0: f32). `hidden` must be a
// multiple of 16, of 80 for the packed form (the wrapper pads with units
// whose weights and inputs are zero). All pointers come from fresh PyTorch
// allocations (256-byte aligned).
//
// ligru_fwd: xg (T,B,2H); wp (H/16, 32, H) bf16 packed w_h (gru_common.cuh);
// mask (B,H) f32; ys (T,B,H); hgs (T,B,2H) bf16 or null; hbuf (2,B,H) bf16
// with buffer 0 zeroed; hcar (B,H) f32 zeroed.
extern "C" int ligru_fwd(const void* xg, const void* wp, const void* mask,
                         void* ys, void* hgs, void* hbuf, void* hcar,
                         int n_steps, int batch, int hidden, int reverse,
                         int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<bf16, LiGruCell>(xg, wp, nullptr, mask, ys, hgs, hbuf,
                                       hcar, n_steps, batch, hidden, reverse,
                                       st);
  return launch_fwd<float, LiGruCell>(xg, wp, nullptr, mask, ys, hgs, hbuf,
                                      hcar, n_steps, batch, hidden, reverse,
                                      st);
}

// ligru_fwd_packed: both directions in one launch, the forward one on xg_f
// (t = 0..T-1), the backward one on xg_b (t = T-1..0), each (T,B,2H); wp
// (2, H/20, 40, H) bf16 packed w_h of both (gru_common.cuh); mask (B,H) f32,
// shared by the two; ys_* (T,B,H); hgs_* (T,B,2H) bf16 or both null; hbuf
// (2,2,B,H) bf16 with buffer 0 of each direction zeroed; hcar (2,B,H) f32
// zeroed. `hidden` must be a multiple of 80.
extern "C" int ligru_fwd_packed(const void* xg_f, const void* xg_b,
                                const void* wp, const void* mask, void* ys_f,
                                void* ys_b, void* hgs_f, void* hgs_b,
                                void* hbuf, void* hcar, int n_steps,
                                int batch, int hidden, int is_bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_packed_fwd<bf16, LiGruCell>(xg_f, xg_b, wp, nullptr, mask,
                                              ys_f, ys_b, hgs_f, hgs_b, hbuf,
                                              hcar, n_steps, batch, hidden,
                                              st);
  return launch_packed_fwd<float, LiGruCell>(xg_f, xg_b, wp, nullptr, mask,
                                             ys_f, ys_b, hgs_f, hgs_b, hbuf,
                                             hcar, n_steps, batch, hidden, st);
}

// ligru_bwd: xg (T,B,2H); wh (H,2H) bf16; mask (B,H) f32; hgs (T,B,2H) bf16;
// ys (T,B,H) bf16; dy (T,B,H); dxg (T,B,2H); xbuf (2,B,2H) bf16; dhz (B,H)
// f32 zeroed.
extern "C" int ligru_bwd(const void* xg, const void* wh, const void* mask,
                         const void* hgs, const void* ys, const void* dy,
                         void* dxg, void* xbuf, void* dhz, int n_steps,
                         int batch, int hidden, int reverse, int is_bf16,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<bf16, LiGruCell>(xg, wh, mask, hgs, ys, dy, dxg, nullptr,
                                       xbuf, dhz, n_steps, batch, hidden,
                                       reverse, st);
  return launch_bwd<float, LiGruCell>(xg, wh, mask, hgs, ys, dy, dxg, nullptr,
                                      xbuf, dhz, n_steps, batch, hidden,
                                      reverse, st);
}

// ligru_bwd_packed: both directions' backward in one launch, the forward one
// on the *_f operands (t = T-1..0), the backward one on the *_b operands
// (t = 0..T-1), each laid out as ligru_bwd's; mask (B,H) f32, shared by the
// two; xbuf (2,2,B,2H) bf16; dhz (2,B,H) f32 zeroed. `hidden` must be a
// multiple of 80.
extern "C" int ligru_bwd_packed(const void* xg_f, const void* xg_b,
                                const void* wh_f, const void* wh_b,
                                const void* mask, const void* hgs_f,
                                const void* hgs_b, const void* ys_f,
                                const void* ys_b, const void* dy_f,
                                const void* dy_b, void* dxg_f, void* dxg_b,
                                void* xbuf, void* dhz, int n_steps, int batch,
                                int hidden, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_packed_bwd<bf16, LiGruCell>(
        xg_f, xg_b, wh_f, wh_b, mask, hgs_f, hgs_b, ys_f, ys_b, dy_f, dy_b,
        dxg_f, dxg_b, nullptr, nullptr, xbuf, dhz, n_steps, batch, hidden,
        st);
  return launch_packed_bwd<float, LiGruCell>(
      xg_f, xg_b, wh_f, wh_b, mask, hgs_f, hgs_b, ys_f, ys_b, dy_f, dy_b,
      dxg_f, dxg_b, nullptr, nullptr, xbuf, dhz, n_steps, batch, hidden, st);
}
