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
// Bound on the H100: the tensor cores. The function needs three base convs
// of each input frame, 2 * 27 * C^2 FLOP per half-rate position, and must
// move s in and two output frames out, 6C bytes: 9C FLOP/byte, 2,304 at
// C=256.
//
// Design: one implicit GEMM on the warp-specialised TMA + wgmma loop
// (wgmma_conv.cuh, kParity) with M = B*T*H*W half-rate positions in th x tw
// patches of one frame, K = 18 taps x C (frame a-1, then frame a) and
// N = 2C (even, then odd output frame). s is read through a 5-D tensor map
// {C, W, H, T, B}: each tap is one box shifted in (x, y, t), TMA's zero
// fill is the spatial padding and, at a = 0, the zero-mode front (t = -1
// is outside the clip, so no tap reads the clip before); replicate mode
// reads frame 0 there. The K-major weight [[K0+K1, K0], [K2, K1+K2]]^T
// [2C, 18C] is summed in f32 and rounded to bf16 once, per parameter, by
// the wrapper, which also encodes its tensor map. The epilogue adds the
// bias in f32, blends with alpha * s[a] (s read with row stride C) and
// writes columns [0, C) to frame 2a and [C, 2C) to frame 2a+1; BN divides
// C. One f32 accumulator holds both frames' taps; the TPU kernel rounds
// the previous-frame taps to the activation dtype first. Nothing carries
// over between blocks, so the price is 36 C^2 MACs per position where the
// TPU kernel's 2-slot VMEM ring of the previous frame's base convs does
// 27 C^2: that ring needs a block that walks its patch through time.
// Offsets are 64-bit: the output passes 2^31 elements at T=102, C=256.
// The plan (patch, BN, stages, shared memory, grid) is
// ops/kernels/plan.py's conv_plan_parity.
#include "wgmma_conv.cuh"

extern "C" int vt_parity_up2x(const void* s, void* out, const void* wmap, const void* bias,
                              const void* alpha, int B, int T, int H, int W, int C,
                              int replicate, int th, int tw, int bn, int stages, int smem,
                              int grid, void* stream) {
  using namespace vt;
  if (C % 128 != 0) return wg::kErrPlan;
  CUtensorMap mw, ms;
  memcpy(&mw, wmap, sizeof(CUtensorMap));
  int e = wg::parity_map(&ms, s, B, T, H, W, C, th, tw);
  if (e) return e;

  wg::Params p{};
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const __nv_bfloat16*>(s);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.alpha = static_cast<const float*>(alpha);
  p.H = H;
  p.W = W;
  p.T = T;
  p.replicate = replicate;
  p.th = th;
  p.tw = tw;
  p.tiles_x = (W + tw - 1) / tw;
  p.tiles_y = (H + th - 1) / th;
  p.n_tiles = 2 * C / bn;
  p.Cout = 2 * C;
  p.cin_steps = C / wg::BK;
  p.k_main = p.k_total = 18 * p.cin_steps;
  p.stages = stages;
  return wg::launch_conv<wg::kParity>(ms, mw, ms, p, bn, smem, grid,
                                      static_cast<cudaStream_t>(stream));
}
