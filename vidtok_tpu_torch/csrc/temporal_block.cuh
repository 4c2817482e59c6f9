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
//
// F32 (wgmma_conv.cuh's f32 scheme): x, the caches, h1, out and the new
// caches f32; the scratch holds the activations' bf16 pieces, a plane of B
// clips each; the caches hold the activated frames in f32, split as they
// enter the scratch. C is any multiple of 8 up to 1024 (partial K steps
// and N tiles, row passes of masked vectors).
#pragma once

#include "wgmma_conv.cuh"

namespace vt {

template <bool F32 = false>
static inline int temporal_block(const void* x, const void* c1, const void* c2, void* out,
                                 void* nc1, void* nc2, void* h1, void* act, const void* g1,
                                 const void* b1, const void* w1map, const void* bias1,
                                 const void* g2, const void* b2, const void* w2map,
                                 const void* bias2, int B, int T, int S, int C, int front,
                                 int offset, int bn, int stages, int smem, int grid,
                                 cudaStream_t s) {
  constexpr int P = F32 ? kPieces : 1;  // scratch channels per channel
  constexpr int form = F32 ? kRowSplit : kRowBf16;
  const long long rows = (long long)B * (T + 2) * S;  // of the scratch
  CUtensorMap mw1, mw2, unused, ma;
  wg::read_weight_maps(w1map, &mw1, &unused);
  wg::read_weight_maps(w2map, &mw2, &unused);
  // the scratch's planes: piece q of clip b is clip q * B + b
  int e = wg::temporal_map(&ma, act, P * B, (long long)(T + 2) * S, C);
  if (e) return e;

  wg::Params p{};
  p.T = T;
  p.S = S;
  p.tiles_x = (int)(((long long)T * S + wg::BM - 1) / wg::BM);
  p.m_tiles = B * p.tiles_x;
  p.par_tiles = p.n_tiles = (C + bn - 1) / bn;
  p.Cout = C;
  p.planes = B;
  p.cin_steps = (C + wg::BK - 1) / wg::BK;
  p.k_main = p.k_base = 3 * p.cin_steps;
  p.k_total = (F32 ? wg::kProducts : 1) * p.k_base;
  p.stages = stages;

  RowArgs r{x, static_cast<const float*>(g1), static_cast<const float*>(b1), act, c1, nc1,
            T, S, front, offset};
  if ((e = launch_act_rows<true, form>(r, rows, C, s))) return e;
  p.bias = static_cast<const float*>(bias1);
  p.out = h1;
  if ((e = wg::launch_conv<wg::kTemporal, F32>(ma, mw1, ma, mw1, p, bn, smem, grid, s)))
    return e;

  r.src = h1;
  r.g = static_cast<const float*>(g2);
  r.b = static_cast<const float*>(b2);
  r.cache = c2;
  r.copy = nc2;
  if ((e = launch_act_rows<true, form>(r, rows, C, s))) return e;
  p.bias = static_cast<const float*>(bias2);
  p.res = x;
  p.out = out;
  return wg::launch_conv<wg::kTemporal, F32>(ma, mw2, ma, mw2, p, bn, smem, grid, s);
}

}  // namespace vt
