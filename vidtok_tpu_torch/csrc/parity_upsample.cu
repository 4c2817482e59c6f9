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
// the wrapper, which also encodes its tensor map, whose parity dimension
// gives each output frame's C columns N tiles of their own. The epilogue
// adds the bias in f32, blends with alpha * s[a] (s read with row stride C)
// and writes parity 0's columns to frame 2a and parity 1's to frame 2a+1.
// C is any multiple of 8 up to 1024: a tap's last K step and each parity's
// last N tile are partial (the loop's masks). One f32 accumulator holds
// both frames' taps; the TPU kernel rounds
// the previous-frame taps to the activation dtype first. Nothing carries
// over between blocks, so the price is 36 C^2 MACs per position where the
// TPU kernel's 2-slot VMEM ring of the previous frame's base convs does
// 27 C^2: that ring needs a block that walks its patch through time.
// Offsets are 64-bit: the output passes 2^31 elements at T=102, C=256.
// The plan (patch, BN, stages, shared memory, grid) is
// ops/kernels/plan.py's conv_plan_parity.
//
// f32 (vt_parity_up2x_f32): s and out f32. A split pass writes s's bf16
// pieces into a [3, B, T, H, W, C] scratch, which the 5-D map reads as 3B
// clips (piece q of clip b is clip q * B + b), the weight is the summed
// matrix split once per parameter, and the
// products are wgmma_conv.cuh's f32 scheme; the epilogue blends with s in
// f32. The TPU kernel declines f32 at 256+ channels (its VMEM,
// parity_upsample_fused.py:134); this one takes f32 wherever it takes
// bf16.
#include "wgmma_conv.cuh"

namespace {

template <bool F32>
int parity_up2x(const void* s, void* sp, void* out, const void* wmap, const void* bias,
                const void* alpha, int B, int T, int H, int W, int C, int replicate, int th,
                int tw, int bn, int stages, int smem, int grid, cudaStream_t stream) {
  using namespace vt;
  int e;
  if (F32 && (e = launch_split_rows(static_cast<const float*>(s),
                                    static_cast<__nv_bfloat16*>(sp),
                                    (long long)B * T * H * W, C, stream)))
    return e;
  CUtensorMap mw, unused, ms;
  wg::read_weight_maps(wmap, &mw, &unused);
  e = wg::parity_map(&ms, F32 ? sp : s, (F32 ? kPieces : 1) * B, T, H, W, C, th, tw);
  if (e) return e;

  wg::Params p{};
  p.bias = static_cast<const float*>(bias);
  p.res = s;
  p.out = out;
  p.alpha = static_cast<const float*>(alpha);
  p.H = H;
  p.W = W;
  p.T = T;
  p.replicate = replicate;
  p.th = th;
  p.tw = tw;
  p.tiles_x = (W + tw - 1) / tw;
  p.tiles_y = (H + th - 1) / th;
  p.m_tiles = B * T * p.tiles_x * p.tiles_y;
  p.par_tiles = (C + bn - 1) / bn;
  p.n_tiles = 2 * p.par_tiles;
  p.Cout = C;
  p.planes = B;
  p.cin_steps = (C + wg::BK - 1) / wg::BK;
  p.k_main = p.k_base = 18 * p.cin_steps;
  p.k_total = (F32 ? wg::kProducts : 1) * p.k_base;
  p.stages = stages;
  return wg::launch_conv<wg::kParity, F32>(ms, mw, ms, mw, p, bn, smem, grid, stream);
}

}  // namespace

extern "C" int vt_parity_up2x(const void* s, void* out, const void* wmap, const void* bias,
                              const void* alpha, int B, int T, int H, int W, int C,
                              int replicate, int th, int tw, int bn, int stages, int smem,
                              int grid, void* stream) {
  return parity_up2x<false>(s, nullptr, out, wmap, bias, alpha, B, T, H, W, C, replicate,
                            th, tw, bn, stages, smem, grid, static_cast<cudaStream_t>(stream));
}

// f32: s, out f32; sp the [3, B, T, H, W, C] bf16 scratch of s's pieces; the
// weight's map over the split K-major operand [2C, 3 * 18C].
extern "C" int vt_parity_up2x_f32(const void* s, void* sp, void* out, const void* wmap,
                                  const void* bias, const void* alpha, int B, int T, int H,
                                  int W, int C, int replicate, int th, int tw, int bn,
                                  int stages, int smem, int grid, void* stream) {
  return parity_up2x<true>(s, sp, out, wmap, bias, alpha, B, T, H, W, C, replicate, th, tw,
                           bn, stages, smem, grid, static_cast<cudaStream_t>(stream));
}
