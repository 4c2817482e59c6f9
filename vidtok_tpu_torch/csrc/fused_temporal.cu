// Kernel B: fused causal temporal residual block (layernorm, non-streaming).
//
// Replaces vidtok_tpu/ops/pallas/fused_temporal.py:205
// fused_temporal_resblock (pallas_call at :243):
//
//   y = x + conv2_t(ln_silu2(conv1_t(ln_silu1(x))))
//
// x: [B, T, S = H*W, C] bf16; both convs causal k=3 over time, C -> C; the
// front pad is of the ACTIVATED tensor (replicate: activated frame 0;
// zero: masked taps); residual added in f32.
//
// Bound on the H100: memory at 128 channels, math at 512. The block does
// 12*C FLOP per element (two k=3 convs) and moves about 14 bytes per
// element (x read for statistics, taps and residual, the intermediate
// written and read twice, the output written): ~110 FLOP/byte at C=128,
// below the ~295 FLOP/byte bf16 ridge, and ~440 at C=512.
//
// Design: the same implicit GEMM as kernel A with time taps: LayerNorm+SiLU
// of x into a bf16 scratch, conv1 over it (taps before frame 0 zero-filled
// or read at frame 0), the same activation of its output, conv2 with x
// added in the epilogue. The three taps of an output tile read the same
// positions of neighbouring frames, which L2 holds between them. The TPU's
// full-T VMEM tile does not carry over; it would not fit shared memory.
#include "igemm_conv.cuh"

extern "C" int vt_fused_temporal_resblock(
    const void* x, void* out, void* h1, void* act, const void* g1,
    const void* b1, const void* w1, const void* bias1, const void* g2,
    const void* b2, const void* w2, const void* bias2, int B, int T, int S,
    int C, int replicate, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * T * S;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h1);
  auto* ab = static_cast<__nv_bfloat16*>(act);
  const igemm::Geometry geo{1, 1, T, S, replicate};

  launch_ln_silu_rows(xb, static_cast<const float*>(g1),
                      static_cast<const float*>(b1), ab, M, C, s);
  const igemm::Params p1{ab, static_cast<const __nv_bfloat16*>(w1),
                         static_cast<const float*>(bias1), nullptr, nullptr,
                         hb, M, C, C, 0};
  igemm::launch_conv<igemm::kTemporal>(p1, geo, s);

  launch_ln_silu_rows(hb, static_cast<const float*>(g2),
                      static_cast<const float*>(b2), ab, M, C, s);
  const igemm::Params p2{ab, static_cast<const __nv_bfloat16*>(w2),
                         static_cast<const float*>(bias2), nullptr, xb,
                         static_cast<__nv_bfloat16*>(out), M, C, C, 0};
  igemm::launch_conv<igemm::kTemporal>(p2, geo, s);
  return (int)cudaGetLastError();
}
