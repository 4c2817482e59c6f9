// The causal k=3 temporal residual block (layernorm) on the wgmma loop,
// shared by kernel B (fused_temporal.cu: a whole clip behind a stream-start
// front) and kernel F (fused_temporal_stream.cu: a chunk behind its caches).
// Four stream-ordered launches over a scratch ``act`` of T + 2 frames per
// clip:
//
//   act  = [front | ln_silu(x; norm1)]   act_rows_kernel, stream form
//   h1   = conv1_t(act) + bias1          wg::conv_kernel, kTemporal
//   act  = [front | ln_silu(h1; norm2)]
//   out  = x + conv2_t(act) + bias2
//
// The front (common.cuh: Front) is the caches c1, c2 (F after its first
// chunk), activated frame 0 twice (F's first chunk, B in replicate mode) or
// zeros (B in zero mode); when nc1, nc2 are not null the prep passes also
// write the new caches, frames [T - offset, T - offset + 2) of each
// scratch. Tap k of an output frame reads the scratch k frames on, so no
// tap needs the stream-start rule. The weights come as tensor maps encoded
// once per parameter by the wrapper; the plan (BN, stages, shared memory,
// grid) is ops/kernels/plan.py's conv_plan_temporal.
#pragma once

#include "wgmma_conv.cuh"

namespace vt {

static inline int temporal_block(const void* x, const void* c1, const void* c2, void* out,
                                 void* nc1, void* nc2, void* h1, void* act, const void* g1,
                                 const void* b1, const void* w1map, const void* bias1,
                                 const void* g2, const void* b2, const void* w2map,
                                 const void* bias2, int B, int T, int S, int C, int front,
                                 int offset, int bn, int stages, int smem, int grid,
                                 cudaStream_t s) {
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
            T, S, front, offset};
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

}  // namespace vt
