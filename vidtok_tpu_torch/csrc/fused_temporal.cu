// Kernel B: fused causal temporal residual block (layernorm, non-streaming).
//
// Replaces vidtok_tpu/ops/pallas/fused_temporal.py:205
// fused_temporal_resblock (pallas_call at :243):
//
//   y = x + conv2_t(ln_silu2(conv1_t(ln_silu1(x))))
//
// x: [B, T, S = H*W, C] bf16; both convs causal k=3 over time, C -> C; the
// front pad is of the ACTIVATED tensor (replicate: activated frame 0;
// zero: zeros); residual added in f32.
//
// Bound on the H100: the tensor cores. The block does 12*C FLOP per
// element (two k=3 convs) and must move x and y, 4 bytes per element: 3*C
// FLOP/byte, 384 at C=128, above the ~295 FLOP/byte bf16 ridge. The scratch
// passes below add ~10 bytes per element of traffic, which at C=128 puts
// the kernel's own traffic under the ridge.
//
// Design: kernel F's four launches (temporal_block.cuh) with the
// stream-start rule as the scratch's 2-frame front and no caches: the prep
// pass writes activated frame 0 twice (replicate) or zeros (zero) into
// frames 0-1 of each clip and LN+SiLU of x into frames 2.., conv1 is the
// warp-specialised TMA + wgmma implicit GEMM (wgmma_conv.cuh, kTemporal),
// tap k reading the scratch k frames on, then the same prep of conv1's
// output and conv2 with x added in its epilogue. Zero mode could do
// without a front (a 3-D map {C, T*S, B} read at row r0 + (k - 2)*S is
// zero-filled by TMA below row 0, inside its clip), but that saves only
// the front's writes, 2 of T + 2 frames of one row pass (T = 20 on the
// serving path), and no products: one code path serves both modes. The
// TPU kernel's full-T VMEM tile does not carry over; it would not fit
// shared memory. vt_fused_temporal_resblock_f32 is the same block on f32
// activations (temporal_block.cuh's F32: the scratch's bf16 pieces in three planes).
#include "temporal_block.cuh"

extern "C" int vt_fused_temporal_resblock(
    const void* x, void* out, void* h1, void* act, const void* g1, const void* b1,
    const void* w1map, const void* bias1, const void* g2, const void* b2,
    const void* w2map, const void* bias2, int B, int T, int S, int C, int replicate,
    int bn, int stages, int smem, int grid, void* stream) {
  using namespace vt;
  return temporal_block(x, nullptr, nullptr, out, nullptr, nullptr, h1, act, g1, b1, w1map,
                        bias1, g2, b2, w2map, bias2, B, T, S, C,
                        replicate ? kFrontReplicate : kFrontZero, 0, bn, stages, smem,
                        grid, static_cast<cudaStream_t>(stream));
}

// f32: x, out, h1 f32 [B, T, S, C]; act the [3, B, T + 2, S, C] bf16 scratch;
// the weights' maps over the split K-major operands [C, 3 * 3C].
extern "C" int vt_fused_temporal_resblock_f32(
    const void* x, void* out, void* h1, void* act, const void* g1, const void* b1,
    const void* w1map, const void* bias1, const void* g2, const void* b2,
    const void* w2map, const void* bias2, int B, int T, int S, int C, int replicate,
    int bn, int stages, int smem, int grid, void* stream) {
  using namespace vt;
  return temporal_block<true>(x, nullptr, nullptr, out, nullptr, nullptr, h1, act, g1, b1,
                              w1map, bias1, g2, b2, w2map, bias2, B, T, S, C,
                              replicate ? kFrontReplicate : kFrontZero, 0, bn, stages, smem,
                              grid, static_cast<cudaStream_t>(stream));
}
