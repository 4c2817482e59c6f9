// The temporal-resblock microbenchmark's kernels T1-T3, the counterparts of
// the Pallas kernels of the JAX package's tools/microbench_temporal.py, over
// x [B, T, S = H*W, C] bf16.
//
// T3 replaces :130 copy_min (pallas_call at :140), the TPU's copy floor:
// out = x, one unit at a time, a unit being tile_t frames x tile_s positions
// x C channels. Bound: bytes (x read and written once). Design: a unit is
// tile_t runs of tile_s * C contiguous values, one per frame; each run is
// cut into 16 KB pieces, one per 256-thread block with four 16-byte loads in
// flight per thread, so even the (tile_t 1, tile_s 4096) tiling of
// [1, 9, 4096, 512], 9 units, puts 2304 blocks on the 132 SMs. Blocks are
// numbered unit by unit, in the TPU grid's order; the card has no per-step
// VMEM buffer to size, so the tiling only orders the work.
//
// T2 replaces :102 fused_diag (pallas_call at :111, body :81), in three
// modes:
//   copy: out = x, T3's copy with one unit per clip;
//   mm:   h = bf16(conv1_t(x)), out = bf16(x + conv2_t(h)), the two causal
//         k=3 time convs with a zero front, no bias and no LN: kernel B's
//         own GEMM loop (wgmma_conv.cuh, launched with
//         plan.conv_plan_temporal's plan and B's weight maps) with the tap
//         set kCausal, which reads x itself through a 3-D map {C, T*S, B}
//         and takes tap k of row r from row r + (k - 2) * S: TMA's zero
//         fill below row 0 of each clip is the zero front. So neither x
//         nor h is copied behind a front (B's scratch pass would cost 2|x|
//         bytes, ~0.02 ms at [1,9,64^2,512] and ~0.2 ms at [1,20,256^2,128]),
//         M tiles that straddle frames (S % 128 != 0) read each row from its
//         own frame, and no tap crosses a clip. conv1's epilogue writes h
//         (bf16, no bias: the loop takes a null bias) and conv2's adds x.
//         Bound: operations at C = 512 (12 C^2 FLOP per position), bytes
//         at 128, as B's products;
//   ln:   a1 = bf16(ln_silu(x; norm1)), a2 = bf16(ln_silu(a1; norm2)),
//         out = bf16(x + a2), the exact LN+SiLU, in registers in one pass
//         over x (ln_twice_kernel). Bound: bytes.
//
// T1 replaces :53 fused_fat (pallas_call at :62): kernel B in zero mode with
// the exact LN+SiLU, the three time taps of each conv concatenated into one
// [M, 3C] x [3C, C] product. Bound: operations at C = 512, as B's; its own
// explicit operand makes it byte-bound at 128. Design: the TPU's question,
// one fat product or three accumulated taps, asked of the loop kernel B
// runs. A row pass (fat_rows_kernel) writes each activated row into its
// three places of the fat operand [a(t-2) | a(t-1) | a(t)] (zeros before
// frame 0 of each clip; a [M, 3C] bf16 scratch); the wgmma loop with the
// tap set kDense (one tap, a 2-D map over the operand, K = 3C in 64-channel
// steps, plan.conv_plan_dense) adds the bias and writes h in f32, because
// the TPU kernel's second LN reads h unrounded; the row pass again, from h;
// the dense product adds the bias and x. Kernel B gives the other answer:
// implicit taps, nothing materialised beyond its activated scratch.
//
// The row passes: act_rows_kernel's layout (common.cuh, VT_ROW_LAYOUTS): a
// row takes LPR = min(C/8, 32) lanes, a warp 32 / LPR rows, each thread
// loads its RPT rows before it reduces any; the statistics are the exact
// two-pass form (row_stats_exact) over the row's LPR lanes; g and b are
// read as vectors, once per vector slot for all of a thread's rows. C in
// plan.ROW_CHANNELS, else cudaErrorInvalidValue.
#include <string.h>

#include "wgmma_conv.cuh"

namespace {

constexpr int kCopyThreads = 256, kCopyVec = 4;  // 16 KB per block

// out = x over the units of a [B, T, S, C] tensor (C8 = C / 8 vectors per
// position): block id = ((unit * tile_t + frame) * pieces + piece), unit =
// (b, t // tile_t, s // tile_s) with the last fastest.
__global__ void copy_units_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                                  int T, int S, int C8, int tile_t, int tile_s,
                                  int nt, int ns, long long pieces) {
  const long long bid = blockIdx.x;
  const long long piece = bid % pieces, fr = bid / pieces;
  const int f = (int)(fr % tile_t);
  const long long unit = fr / tile_t;
  const int ks = (int)(unit % ns);
  const long long rest = unit / ns;
  const int kt = (int)(rest % nt);
  const long long b = rest / nt;
  const long long run = (long long)tile_s * C8;
  const long long start =
      ((b * T + (long long)kt * tile_t + f) * S + (long long)ks * tile_s) * C8;
  const long long v0 = piece * (kCopyThreads * kCopyVec) + threadIdx.x;
  uint4 r[kCopyVec];
#pragma unroll
  for (int k = 0; k < kCopyVec; ++k)
    if (v0 + k * kCopyThreads < run) r[k] = x[start + v0 + k * kCopyThreads];
#pragma unroll
  for (int k = 0; k < kCopyVec; ++k)
    if (v0 + k * kCopyThreads < run) out[start + v0 + k * kCopyThreads] = r[k];
}

void launch_copy(const void* x, void* out, int B, int T, int S, int C, int tile_t,
                 int tile_s, cudaStream_t s) {
  const int nt = T / tile_t, ns = S / tile_s;
  const long long run = (long long)tile_s * (C / 8);
  const long long pieces = (run + kCopyThreads * kCopyVec - 1) / (kCopyThreads * kCopyVec);
  const long long blocks = (long long)B * nt * ns * tile_t * pieces;
  copy_units_kernel<<<(unsigned)blocks, kCopyThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), T, S, C / 8, tile_t,
      tile_s, nt, ns, pieces);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  vt::unpack8(vt::ld_u4(p), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16(f));
}

// First row of this thread (rows of a warp: 32 / LPR at a time, RPT times).
template <int LPR, int RPT>
__device__ __forceinline__ long long first_row(int lane) {
  return ((long long)blockIdx.x * 8 + (threadIdx.x >> 5)) * ((32 / LPR) * RPT) + lane / LPR;
}

// The RPT rows of C = 8 LPR VPL channels of this thread, rows past ``rows``
// as zeros (they take part in the shuffles and are not stored).
template <int LPR, int VPL, int RPT, typename In>
__device__ __forceinline__ void load_rows(const In* __restrict__ src, long long row0,
                                          long long rows, int l, float (&v)[RPT][VPL][8]) {
  constexpr int RPW = 32 / LPR, C = 8 * LPR * VPL;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long row = row0 + (long long)k * RPW;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (row < rows) {
        load8(src + row * C + 8 * l + 8 * LPR * i, v[k][i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][i][e] = 0.f;
      }
    }
  }
}

// g and b of channels c .. c + 7, as vectors.
__device__ __forceinline__ void load_gb(const float* g, const float* b, int c, float* gv,
                                        float* bv) {
  load8(g + c, gv);
  load8(b + c, bv);
}

// For row = (clip, t, s) of src [B, T, S, C] (bf16 x, or f32 h): a =
// bf16(ln_silu_exact_f32(src[row])) is written to the fat operand fat
// [B*T*S, 3C] in column block 2 of row (clip, t, s), block 1 of (clip, t+1,
// s) and block 0 of (clip, t+2, s), where those frames exist; the blocks of
// frames 0 and 1 that no frame fills (taps before frame 0) are zeroed.
template <int LPR, int VPL, int RPT, typename In>
static __global__ void __launch_bounds__(256)
    fat_rows_kernel(const In* __restrict__ src, const float* __restrict__ g,
                    const float* __restrict__ b, __nv_bfloat16* __restrict__ fat, int T,
                    int S, long long rows) {
  constexpr int RPW = 32 / LPR, C = 8 * LPR * VPL;
  const int lane = threadIdx.x & 31, l = lane % LPR;
  const long long row0 = first_row<LPR, RPT>(lane);
  float v[RPT][VPL][8];
  load_rows<LPR, VPL, RPT>(src, row0, rows, l, v);
  // the frame of each row: that of the first (one division), then stepped
  // RPW rows at a time
  int fr[RPT];
  {
    const long long q = row0 / S;
    int pos = (int)(row0 - q * S), f = (int)(q % T);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (k > 0)
        for (pos += RPW; pos >= S; pos -= S)
          if (++f == T) f = 0;
      fr[k] = f;
    }
  }
  float2 st[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) st[k] = vt::row_stats_exact<LPR, VPL>(v[k]);
  const long long ld = 3LL * C, next = (long long)S * ld;
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = 8 * l + 8 * LPR * i;
    float gv[8], bv[8];
    load_gb(g, b, c, gv, bv);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const long long row = row0 + (long long)k * RPW;
      if (row >= rows) continue;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = vt::ln_silu_exact_f32(v[k][i][e], st[k].x, st[k].y, gv[e], bv[e]);
      const uint4 a = vt::pack8(f);
      __nv_bfloat16* p = fat + row * ld + c;
      *reinterpret_cast<uint4*>(p + 2 * C) = a;
      if (fr[k] + 1 < T) *reinterpret_cast<uint4*>(p + next + C) = a;
      if (fr[k] + 2 < T) *reinterpret_cast<uint4*>(p + 2 * next) = a;
      if (fr[k] < 2) *reinterpret_cast<uint4*>(p) = zero;
      if (fr[k] < 1) *reinterpret_cast<uint4*>(p + C) = zero;
    }
  }
}

template <typename In>
int launch_fat_rows(const In* src, const void* g, const void* b, __nv_bfloat16* fat, int T,
                    int S, int C, long long rows, cudaStream_t s) {
  const auto* gf = static_cast<const float*>(g);
  const auto* bf = static_cast<const float*>(b);
#define VT_FAT_ROWS(L, V, R)                                                              \
  {                                                                                       \
    const long long per = 8LL * (32 / L) * R;                                             \
    fat_rows_kernel<L, V, R, In><<<(unsigned)((rows + per - 1) / per), 256, 0, s>>>(     \
        src, gf, bf, fat, T, S, rows);                                                    \
    return (int)cudaGetLastError();                                                       \
  }
  VT_ROW_LAYOUTS(C, VT_FAT_ROWS)
#undef VT_FAT_ROWS
  return (int)cudaErrorInvalidValue;
}

// out[row] = bf16(x + a2), a2 = bf16(ln_silu_exact_f32(a1; g2, b2)),
// a1 = bf16(ln_silu_exact_f32(x; g1, b1)), in registers: x as f32, a1 as
// the bf16 it is rounded to (half the registers, nothing lost). Three
// blocks an SM (at most 80 registers a thread, a few bytes spilled to L1)
// ran about 5% faster than two without spills; holding x packed as well
// gained nothing more. The pass's exp and division (two SFU operations a
// value each LN) take about as long as its bytes, so it sits between
// the two bounds.
template <int LPR, int VPL, int RPT>
static __global__ void __launch_bounds__(256, 3)
    ln_twice_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g1,
                    const float* __restrict__ b1, const float* __restrict__ g2,
                    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                    long long rows) {
  constexpr int RPW = 32 / LPR, C = 8 * LPR * VPL;
  const int lane = threadIdx.x & 31, l = lane % LPR;
  const long long row0 = first_row<LPR, RPT>(lane);
  float v[RPT][VPL][8];
  uint4 a[RPT][VPL];
  load_rows<LPR, VPL, RPT>(x, row0, rows, l, v);
  float2 st[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) st[k] = vt::row_stats_exact<LPR, VPL>(v[k]);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    float gv[8], bv[8];
    load_gb(g1, b1, 8 * l + 8 * LPR * i, gv, bv);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = vt::ln_silu_exact_f32(v[k][i][e], st[k].x, st[k].y, gv[e], bv[e]);
      a[k][i] = vt::pack8(f);
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    float f[VPL][8];
#pragma unroll
    for (int i = 0; i < VPL; ++i) vt::unpack8(a[k][i], f[i]);
    st[k] = vt::row_stats_exact<LPR, VPL>(f);
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = 8 * l + 8 * LPR * i;
    float gv[8], bv[8];
    load_gb(g2, b2, c, gv, bv);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const long long row = row0 + (long long)k * RPW;
      if (row >= rows) continue;
      float f[8];
      vt::unpack8(a[k][i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = v[k][i][e] + round_bf16(vt::ln_silu_exact_f32(f[e], st[k].x, st[k].y, gv[e], bv[e]));
      *reinterpret_cast<uint4*>(out + row * C + c) = vt::pack8(f);
    }
  }
}

int launch_ln_twice(const __nv_bfloat16* x, const float* g1, const float* b1,
                    const float* g2, const float* b2, __nv_bfloat16* out, int C,
                    long long rows, cudaStream_t s) {
#define VT_LN_TWICE(L, V, R)                                                              \
  {                                                                                       \
    const long long per = 8LL * (32 / L) * R;                                             \
    ln_twice_kernel<L, V, R><<<(unsigned)((rows + per - 1) / per), 256, 0, s>>>(         \
        x, g1, b1, g2, b2, out, rows);                                                    \
    return (int)cudaGetLastError();                                                       \
  }
  VT_ROW_LAYOUTS(C, VT_LN_TWICE)
#undef VT_LN_TWICE
  return (int)cudaErrorInvalidValue;
}

// The wgmma loop's parameters of a C -> C product with K = 3C, in K steps
// of 64 channels of ``tap_channels`` per tap: a kCausal conv (C) over clips
// of T frames of S rows, or a kDense product (3C, one tap) over M = S rows
// (T = 1).
vt::wg::Params loop_params(int T, int S, int C, int tap_channels, int bn, int stages) {
  vt::wg::Params p{};
  p.T = T;
  p.S = S;
  p.tiles_x = (int)(((long long)T * S + vt::wg::BM - 1) / vt::wg::BM);
  p.n_tiles = C / bn;
  p.Cout = C;
  p.cin_steps = tap_channels / vt::wg::BK;
  p.k_main = p.k_total = 3 * C / vt::wg::BK;
  p.stages = stages;
  return p;
}

}  // namespace

// T3: C % 8 == 0, tile_t | T, tile_s | S.
extern "C" int vt_copy_units(const void* x, void* out, int B, int T, int S, int C,
                             int tile_t, int tile_s, void* stream) {
  launch_copy(x, out, B, T, S, C, tile_t, tile_s, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// T2: mode 0 copy, 1 mm, 2 ln. mm: h a [B, T, S, C] bf16 scratch, w1map and
// w2map the K-major [C, 3C] weights' tensor maps, (bn, stages, smem, grid)
// plan.conv_plan_temporal's plan; ln: C in plan.ROW_CHANNELS.
extern "C" int vt_microbench_diag(const void* x, void* out, void* h, const void* g1,
                                  const void* b1, const void* w1map, const void* g2,
                                  const void* b2, const void* w2map, int B, int T, int S,
                                  int C, int mode, int bn, int stages, int smem, int grid,
                                  void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * T * S;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (mode == 0) {
    launch_copy(x, out, B, T, S, C, T, S, s);
    return (int)cudaGetLastError();
  }
  if (mode == 2)
    return launch_ln_twice(xb, static_cast<const float*>(g1), static_cast<const float*>(b1),
                           static_cast<const float*>(g2), static_cast<const float*>(b2), ob,
                           C, M, s);
  CUtensorMap mx, mh, mw1, mw2;
  memcpy(&mw1, w1map, sizeof(CUtensorMap));
  memcpy(&mw2, w2map, sizeof(CUtensorMap));
  int e = wg::temporal_map(&mx, x, B, (long long)T * S, C);
  if (e || (e = wg::temporal_map(&mh, h, B, (long long)T * S, C))) return e;
  wg::Params p = loop_params(T, S, C, C, bn, stages);
  p.out = static_cast<__nv_bfloat16*>(h);  // no bias
  if ((e = wg::launch_conv<wg::kCausal>(mx, mw1, mx, p, bn, smem, grid, s))) return e;
  p.res = xb;
  p.out = ob;
  return wg::launch_conv<wg::kCausal>(mh, mw2, mh, p, bn, smem, grid, s);
}

// T1: C in plan.ROW_CHANNELS, C % 128 == 0; fat a [B*T*S, 3C] bf16 scratch,
// h a [B*T*S, C] f32 scratch; w1map, w2map the K-major [C, 3C] weights'
// tensor maps, (bn, stages, smem, grid) plan.conv_plan_dense's plan.
extern "C" int vt_microbench_fat(const void* x, void* out, void* fat, void* h,
                                 const void* g1, const void* b1, const void* w1map,
                                 const void* bias1, const void* g2, const void* b2,
                                 const void* w2map, const void* bias2, int B, int T, int S,
                                 int C, int bn, int stages, int smem, int grid, void* stream) {
  using namespace vt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)B * T * S;
  if (M > 0x7fffffffLL - wg::BM) return wg::kErrPlan;  // TMA's row coordinate
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* fb = static_cast<__nv_bfloat16*>(fat);
  auto* hf = static_cast<float*>(h);
  CUtensorMap ma, mw1, mw2;
  memcpy(&mw1, w1map, sizeof(CUtensorMap));
  memcpy(&mw2, w2map, sizeof(CUtensorMap));
  int e = wg::weight_map(&ma, fat, 3 * C, (int)M, wg::BM);  // [M, 3C], K-major
  if (e) return e;
  wg::Params p = loop_params(1, (int)M, C, 3 * C, bn, stages);

  if ((e = launch_fat_rows(xb, g1, b1, fb, T, S, C, M, s))) return e;
  p.bias = static_cast<const float*>(bias1);
  p.outf = hf;
  if ((e = wg::launch_conv<wg::kDense>(ma, mw1, ma, p, bn, smem, grid, s))) return e;

  if ((e = launch_fat_rows(static_cast<const float*>(hf), g2, b2, fb, T, S, C, M, s))) return e;
  p.bias = static_cast<const float*>(bias2);
  p.outf = nullptr;
  p.res = xb;
  p.out = static_cast<__nv_bfloat16*>(out);
  return wg::launch_conv<wg::kDense>(ma, mw2, ma, p, bn, smem, grid, s);
}
