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
// Bound on the H100: that of kernel B (fused_temporal.cu), memory at 128
// channels and math at 512. The step does 12*C FLOP per element of x and
// must move x and y and read and write 4 cache frames: 4 + 16/t bytes per
// element, so 77-320 FLOP/byte at C=128 for t = 1..20, under the ~295
// FLOP/byte bf16 ridge below t = 14, and 4x that at C=512. The scratch
// passes below add ~10 bytes per element of traffic, much of it from L2
// at the decoder's small chunks.
//
// Design: a prep pass (act_rows_kernel's stream form, the whole warp busy)
// writes the cache (or activated frame 0) into frames 0-1 of a scratch of
// t + 2 frames per clip and LN+SiLU of the input into frames 2.., and
// writes the frames that make the new cache a second time, into it. conv1
// is the warp-specialised TMA + wgmma implicit GEMM (wgmma_conv.cuh) with
// kTemporal taps, tap k reading the scratch k frames on, so every tap
// reads a real frame and no tap needs the stream-start rule. The prep pass
// then refills the scratch from h and c2 (writing the new c2), and conv2
// adds x in its epilogue. The weights come as tensor maps encoded once per
// parameter by the wrapper; the plan (BN, stages, shared memory, grid) is
// ops/kernels/plan.py's conv_plan_temporal.
#include "wgmma_conv.cuh"

extern "C" int vt_fused_temporal_resblock_stream(
    const void* x, const void* c1, const void* c2, void* out, void* nc1, void* nc2,
    void* h1, void* act, const void* g1, const void* b1, const void* w1map,
    const void* bias1, const void* g2, const void* b2, const void* w2map,
    const void* bias2, int B, int T, int S, int C, int first, int offset, int bn,
    int stages, int smem, int grid, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h1);
  auto* ab = static_cast<__nv_bfloat16*>(act);
  const long long rows = (long long)B * (T + 2) * S;  // of the scratch
  CUtensorMap mw1, mw2, ma;
  memcpy(&mw1, w1map, sizeof(CUtensorMap));
  memcpy(&mw2, w2map, sizeof(CUtensorMap));
  int e = wg::temporal_map(&ma, ab, B, (long long)(T + 2) * S, C);
  if (e) return e;

  wg::Params p{};
  p.T = T;
  p.S = S;
  p.tiles_x = (int)(((long long)T * S + wg::BM - 1) / wg::BM);
  p.n_tiles = C / bn;
  p.Cout = C;
  p.cin_steps = C / wg::BK;
  p.k_main = p.k_total = 3 * p.cin_steps;
  p.stages = stages;

  RowArgs r{xb, static_cast<const float*>(g1), static_cast<const float*>(b1), ab,
            static_cast<const __nv_bfloat16*>(c1), static_cast<__nv_bfloat16*>(nc1),
            T, S, first, offset};
  if ((e = launch_act_rows<true>(r, rows, C, s))) return e;
  p.bias = static_cast<const float*>(bias1);
  p.out = hb;
  if ((e = wg::launch_conv<wg::kTemporal>(ma, mw1, ma, p, bn, smem, grid, s))) return e;

  r.src = hb;
  r.g = static_cast<const float*>(g2);
  r.b = static_cast<const float*>(b2);
  r.cache = static_cast<const __nv_bfloat16*>(c2);
  r.copy = static_cast<__nv_bfloat16*>(nc2);
  if ((e = launch_act_rows<true>(r, rows, C, s))) return e;
  p.bias = static_cast<const float*>(bias2);
  p.res = xb;
  p.out = static_cast<__nv_bfloat16*>(out);
  return wg::launch_conv<wg::kTemporal>(ma, mw2, ma, p, bn, smem, grid, s);
}
