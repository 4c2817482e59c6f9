// Kernel A: fused per-frame spatial residual block (layernorm).
//
// Replaces vidtok_tpu/ops/pallas/fused_spatial_v2.py:183
// fused_spatial_resblock_v2 (pallas_call at :249):
//
//   out = shortcut(x) + conv2(ln_silu2(conv1(ln_silu1(x))))
//
// x: [N = B*T, H, W, Cin] bf16; two 3x3 SAME convs Cin -> C -> C with f32
// accumulation; shortcut = x, or a 1x1 nin_shortcut when Cin != C.
//
// Bound on the H100: the tensor cores. The block does 36*C FLOP per
// element (two 3x3 convs) and moves about 14 bytes per element (x read for
// statistics, taps and shortcut, the intermediate written and read twice,
// the output written): ~330 FLOP/byte at C=128, at the ~295 FLOP/byte bf16
// ridge, and 2-4x above it at 256-512 channels.
//
// Design: four stream-ordered launches, counted as one call by the
// wrapper: LayerNorm+SiLU of x into a bf16 scratch (act_rows_kernel, the
// whole warp busy), conv1 as the warp-specialised TMA + wgmma implicit
// GEMM over it (wgmma_conv.cuh, kSpatial) with bias, the same activation of
// conv1's output, and conv2 with the 1x1 shortcut appended as extra K steps
// over raw x (its bias folded into conv2's) or x added in the epilogue.
// TMA zero-fills the taps outside the frame, so both convs' SAME padding is
// a true zero after the activation. Each position is activated once and
// its activation read from L2 by the 9 taps; the TPU kernel kept the
// activation in VMEM instead, which here would cost recomputing it per tap
// (measured 2-3x slower: the first version of this kernel).
//
// The weights come as tensor maps of K-major operands [C, 9*Cin] and
// [C, 9*C (+ Cin)], encoded once per parameter by the wrapper (main and
// 1x1 maps side by side, wgmma_conv.cuh: weight_maps); the scratch's maps
// are encoded here, per call. The plan (th x tw patch, BN, stages, shared
// memory, grid) is ops/kernels/plan.py's conv_plan_spatial. Cin and C are
// any multiples of 8 up to 1024: partial K steps and N tiles (the loop's
// masks), row passes of masked vectors.
//
// f32 (vt_fused_spatial_resblock_f32): x, out and h1 f32; the same four
// launches under wgmma_conv.cuh's f32 scheme. The row passes write the
// activations' bf16 pieces into a scratch of three planes and, when the
// block has its nin_shortcut, the first writes raw x's pieces too (xs),
// which conv2's 1x1 K steps read; the epilogues add the residual and write
// in f32.
#include "wgmma_conv.cuh"

namespace {

template <bool F32>
int spatial_block(const void* x, void* out, void* h1, void* act, void* xs, const void* g1,
                  const void* b1, const void* w1map, const void* bias1, const void* g2,
                  const void* b2, const void* w2map, const void* bias2, int N, int H, int W,
                  int Cin, int C, int has_nin, int th, int tw, int bn, int stages, int smem,
                  int grid, void* stream) {
  using namespace vt;
  constexpr int P = F32 ? kPieces : 1;  // scratch channels per channel
  constexpr int form = F32 ? kRowSplit : kRowBf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * H * W;
  CUtensorMap mw1, mw1x, mw2, mw2x, ma1, ma2, mx;
  wg::read_weight_maps(w1map, &mw1, &mw1x);
  wg::read_weight_maps(w2map, &mw2, &mw2x);
  int e;
  // the scratch's planes: piece q of image n is image q * N + n
  if ((e = wg::spatial_map(&ma1, act, P * N, H, W, Cin, th, tw)) ||
      (e = wg::spatial_map(&ma2, act, P * N, H, W, C, th, tw)) ||
      (e = wg::spatial_map(&mx, F32 ? xs : x, P * N, H, W, Cin, th, tw)))
    return e;

  wg::Params p{};
  p.H = H;
  p.W = W;
  p.th = th;
  p.tw = tw;
  p.tiles_x = (W + tw - 1) / tw;
  p.tiles_y = (H + th - 1) / th;
  p.m_tiles = N * p.tiles_x * p.tiles_y;
  p.par_tiles = p.n_tiles = (C + bn - 1) / bn;
  p.Cout = C;
  p.planes = N;
  p.stages = stages;

  RowArgs r{x, static_cast<const float*>(g1), static_cast<const float*>(b1), act};
  if (F32 && has_nin) r.raw = xs;
  if ((e = launch_act_rows<false, form>(r, M, Cin, s))) return e;
  p.bias = static_cast<const float*>(bias1);
  p.out = h1;
  p.cin_steps = (Cin + wg::BK - 1) / wg::BK;
  p.k_main = p.k_base = 9 * p.cin_steps;
  p.k_total = (F32 ? wg::kProducts : 1) * p.k_base;
  if ((e = wg::launch_conv<wg::kSpatial, F32>(ma1, mw1, mx, mw1x, p, bn, smem, grid, s)))
    return e;

  r = RowArgs{h1, static_cast<const float*>(g2), static_cast<const float*>(b2), act};
  if ((e = launch_act_rows<false, form>(r, M, C, s))) return e;
  p.bias = static_cast<const float*>(bias2);
  p.res = has_nin ? nullptr : x;
  p.out = out;
  p.cin_steps = (C + wg::BK - 1) / wg::BK;
  p.k_main = 9 * p.cin_steps;
  p.k_base = p.k_main + (has_nin ? (Cin + wg::BK - 1) / wg::BK : 0);
  p.k_total = (F32 ? wg::kProducts : 1) * p.k_base;
  return wg::launch_conv<wg::kSpatial, F32>(ma2, mw2, mx, mw2x, p, bn, smem, grid, s);
}

}  // namespace

extern "C" int vt_fused_spatial_resblock(
    const void* x, void* out, void* h1, void* act, const void* g1, const void* b1,
    const void* w1map, const void* bias1, const void* g2, const void* b2,
    const void* w2map, const void* bias2, int N, int H, int W, int Cin, int C,
    int has_nin, int th, int tw, int bn, int stages, int smem, int grid, void* stream) {
  return spatial_block<false>(x, out, h1, act, nullptr, g1, b1, w1map, bias1, g2, b2, w2map,
                              bias2, N, H, W, Cin, C, has_nin, th, tw, bn, stages, smem, grid,
                              stream);
}

// f32: ``act`` [3, N*H*W, max(Cin, C)] and ``xs`` [3, N*H*W, Cin] (or null
// without the nin_shortcut) bf16 scratch, a plane a piece; the weights'
// maps over the split K-major operands [C, 3 K].
extern "C" int vt_fused_spatial_resblock_f32(
    const void* x, void* out, void* h1, void* act, void* xs, const void* g1, const void* b1,
    const void* w1map, const void* bias1, const void* g2, const void* b2,
    const void* w2map, const void* bias2, int N, int H, int W, int Cin, int C,
    int has_nin, int th, int tw, int bn, int stages, int smem, int grid, void* stream) {
  if (has_nin && xs == nullptr) return vt::wg::kErrPlan;
  return spatial_block<true>(x, out, h1, act, xs, g1, b1, w1map, bias1, g2, b2, w2map, bias2,
                             N, H, W, Cin, C, has_nin, th, tw, bn, stages, smem, grid, stream);
}
