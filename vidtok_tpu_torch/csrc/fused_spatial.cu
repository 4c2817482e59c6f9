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
// wrapper: LayerNorm+SiLU of x into a bf16 scratch (one warp per
// position), conv1 as an implicit GEMM over it with bias, the same
// activation of conv1's output, and conv2 with the 1x1 shortcut appended
// as extra K rows over raw x (its bias folded into conv2's) or x added in
// the epilogue. Padding taps are zero-filled copies, so both convs' SAME
// padding is a true zero after the activation. Each position is activated
// once and its activation read from L2 by the 9 taps; the TPU kernel kept
// the activation in VMEM instead, which here would cost recomputing it per
// tap (measured 2-3x slower: the first version of this kernel). There is
// no halo tiling; wgmma/TMA pipelines are later work.
#include "igemm_conv.cuh"

extern "C" int vt_fused_spatial_resblock(
    const void* x, void* out, void* h1, void* act, const void* g1,
    const void* b1, const void* w1, const void* bias1, const void* g2,
    const void* b2, const void* w2, const void* bias2, int N, int H, int W,
    int Cin, int C, int has_nin, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * H * W;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h1);
  auto* ab = static_cast<__nv_bfloat16*>(act);
  const igemm::Geometry geo{H, W, 1, 1, 0};

  launch_ln_silu_rows(xb, static_cast<const float*>(g1),
                      static_cast<const float*>(b1), ab, M, Cin, s);
  const igemm::Params p1{ab, static_cast<const __nv_bfloat16*>(w1),
                         static_cast<const float*>(bias1), nullptr, nullptr,
                         hb, M, Cin, C, 0};
  igemm::launch_conv<igemm::kSpatial>(p1, geo, s);

  launch_ln_silu_rows(hb, static_cast<const float*>(g2),
                      static_cast<const float*>(b2), ab, M, C, s);
  const igemm::Params p2{ab, static_cast<const __nv_bfloat16*>(w2),
                         static_cast<const float*>(bias2),
                         has_nin ? xb : nullptr, has_nin ? nullptr : xb,
                         static_cast<__nv_bfloat16*>(out), M, C, C,
                         has_nin ? Cin : 0};
  igemm::launch_conv<igemm::kSpatial>(p2, geo, s);
  return (int)cudaGetLastError();
}
