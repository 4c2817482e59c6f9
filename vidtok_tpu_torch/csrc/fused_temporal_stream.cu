// Kernel F: one chunk step of the causal temporal residual block (layernorm)
// in a stream, with a 2-frame cache per conv.
//
// Replaces vidtok_tpu/ops/pallas/fused_temporal.py:274
// fused_temporal_resblock_stream (pallas_call at :308, body _stream_kernel
// at :72). For x [B, t, S = H*W, C] bf16 and caches c1, c2 [B, 2, S, C] bf16
// holding ACTIVATED frames:
//
//   a1    = ln_silu(x; norm1)
//   full1 = [c1 | a1]        (first chunk: activated frame 0 twice)
//   h     = conv1_t(full1) + b1        VALID k=3 in time: t output frames
//   a2    = ln_silu(h; norm2)
//   full2 = [c2 | a2]        (first chunk: a2 frame 0 twice)
//   y     = x + conv2_t(full2) + b2    residual in f32
//   new c1, c2 = full1, full2 frames [L-off-2, L-off), L = t + 2
//
// Bound on the H100: memory at 128 channels for short chunks, math at 512.
// The step does 12*C FLOP per element of x and
// must move x and y and read and write 4 cache frames: 4 + 16/t bytes per
// element, so 77-320 FLOP/byte at C=128 for t = 1..20, under the ~295
// FLOP/byte bf16 ridge below t = 14, and 4x that at C=512. The scratch
// passes below add ~10 bytes per element of traffic, much of it from L2
// at the decoder's small chunks.
//
// Design: temporal_block.cuh with the caches as the front (activated frame
// 0 twice on the first chunk): a prep pass (act_rows_kernel's stream form,
// the whole warp busy) writes the front into frames 0-1 of a scratch of
// t + 2 frames per clip and LN+SiLU of the input into frames 2.., and
// writes the frames that make the new cache a second time, into it. conv1
// is the warp-specialised TMA + wgmma implicit GEMM (wgmma_conv.cuh) with
// kTemporal taps. The prep pass then refills the scratch from h and c2
// (writing the new c2), and conv2 adds x in its epilogue.
// vt_fused_temporal_resblock_stream_f32 is the same step on f32
// activations and f32 caches (temporal_block.cuh's F32).
#include "temporal_block.cuh"

extern "C" int vt_fused_temporal_resblock_stream(
    const void* x, const void* c1, const void* c2, void* out, void* nc1, void* nc2,
    void* h1, void* act, const void* g1, const void* b1, const void* w1map,
    const void* bias1, const void* g2, const void* b2, const void* w2map,
    const void* bias2, int B, int T, int S, int C, int first, int offset, int bn,
    int stages, int smem, int grid, void* stream) {
  using namespace vt;
  return temporal_block(x, c1, c2, out, nc1, nc2, h1, act, g1, b1, w1map, bias1, g2, b2,
                        w2map, bias2, B, T, S, C, first ? kFrontReplicate : kFrontCache,
                        offset, bn, stages, smem, grid, static_cast<cudaStream_t>(stream));
}

// f32: x, c1, c2, out, nc1, nc2, h1 f32; act the [3, B, T + 2, S, C] bf16
// scratch; the weights' maps over the split K-major operands [C, 3 * 3C].
extern "C" int vt_fused_temporal_resblock_stream_f32(
    const void* x, const void* c1, const void* c2, void* out, void* nc1, void* nc2,
    void* h1, void* act, const void* g1, const void* b1, const void* w1map,
    const void* bias1, const void* g2, const void* b2, const void* w2map,
    const void* bias2, int B, int T, int S, int C, int first, int offset, int bn,
    int stages, int smem, int grid, void* stream) {
  using namespace vt;
  return temporal_block<true>(x, c1, c2, out, nc1, nc2, h1, act, g1, b1, w1map, bias1, g2,
                              b2, w2map, bias2, B, T, S, C,
                              first ? kFrontReplicate : kFrontCache, offset, bn, stages,
                              smem, grid, static_cast<cudaStream_t>(stream));
}
