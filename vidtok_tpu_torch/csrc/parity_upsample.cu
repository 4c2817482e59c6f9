// Kernel E: nearest 2x temporal upsample + causal 3x3x3 conv + blend.
//
// Replaces vidtok_tpu/ops/pallas/parity_upsample_fused.py:108
// parity_up2x_fused (pallas_call at :150). With Kj the 3x3 spatial taps of
// time tap j, s the half-rate input [B, T, H, W, C] and s[-1] the stream
// start (zeros, or s[0] in replicate mode):
//
//   y[2a]     = K2 (*) s[a] + (K0+K1) (*) s[a-1]
//   y[2a+1]   = (K1+K2) (*) s[a] + K0 (*) s[a-1]
//   out[2a+p] = alpha * s[a] + (1 - alpha) * (y[2a+p] + bias)
//
// Bound on the H100: the tensor cores. Per half-rate position it does
// 2 * 18 * C * 2C FLOP and moves about 6C bytes (s read for the taps and
// the blend, two output frames written): 12C FLOP/byte, 3,072 at C=256.
//
// Design: one implicit GEMM (igemm_conv.cuh, kParity) with M = B*T*H*W
// half-rate positions, K = 18 taps x C (frame a-1, then frame a) and
// N = 2C (even, then odd output frame); the weight operand
// [[K0+K1, K0], [K2, K1+K2]] is summed in f32 and rounded to bf16 once by
// the wrapper. Every block gathers frame a-1 from device memory itself, so
// nothing carries over between blocks: the TPU kernel's 2-slot VMEM ring of
// the previous frame's taps needs its grid to run t in order, which Hopper
// blocks do not. The epilogue adds the bias in f32, blends with alpha *
// s[a] and writes columns [0, C) to frame 2a and [C, 2C) to frame 2a+1.
// The price is 36 C^2 MACs per position where the TPU kernel's three base
// convs do 27 C^2. One f32 accumulator holds both frames' taps; the TPU
// kernel rounds the previous-frame taps to the activation dtype first.
// Offsets are 64-bit: the output passes 2^31 elements at T=102, C=256.
#include "igemm_conv.cuh"

extern "C" int vt_parity_up2x(const void* s, void* out, const void* w,
                              const void* bias, const void* alpha, int B, int T,
                              int H, int W, int C, int replicate, void* stream) {
  using namespace vt;
  const igemm::Geometry geo{H, W, T, 1, replicate};
  igemm::Params p{static_cast<const __nv_bfloat16*>(s),
                  static_cast<const __nv_bfloat16*>(w),
                  static_cast<const float*>(bias), nullptr, nullptr,
                  static_cast<__nv_bfloat16*>(out),
                  (long long)B * T * H * W, C, 2 * C, 0,
                  static_cast<const float*>(alpha)};
  igemm::launch_conv<igemm::kParity>(p, geo, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
